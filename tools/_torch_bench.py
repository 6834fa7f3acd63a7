"""Shared pieces of the port's measurement tools (``bench_torch.py``,
``tools/bench_*_torch.py`` and ``tools/micro_bench_*_torch.py``): the
JAX tools' stub tokenizers and tiny LLaVA widths, the device stamp every
record carries, the barrier that ends a timed region, the clocks of a
call (CUDA events, the host, the profiler's device time) with the
launches and host reads it made, the memory reading and the git
revision. Imports the standard library at the top, torch inside the
functions that need it.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Optional

from tools._torch_eval import ROOT

# where the port's measurement records go (the JAX package's own records
# under artifacts/ are the TPU's and are never written here)
TORCH_ARTIFACTS = os.path.join(ROOT, "artifacts", "torch")

N_TEXT = 60          # the stub tokenizers' prompt length
# the llava-v1.6-mistral-7b anyres grid (bench_vla_anyres.py:41)
V16_PINPOINTS = ((336, 672), (672, 336), (672, 672), (1008, 336),
                 (336, 1008))
# the JAX tools' --tiny LLaVA (bench_vla_service.py:124-131)
TINY_LLAVA = dict(vis_hidden=16, vis_intermediate=32, vis_layers=1,
                  vis_heads=2, image_size=28, patch_size=14, vocab_size=128,
                  hidden=16, intermediate=32, layers=2, heads=2, kv_heads=1,
                  image_token_index=100)
TINY_PINPOINTS = ((28, 56), (56, 28), (56, 56))


def _hash_decimal(ids) -> str:
    """Injective token path -> decimal, so a parsed-score match proves
    the greedy tokens match."""
    key = 0
    for i in ids:
        key = (key * 1000003 + int(i) + 1) % (10 ** 9)
    return f"0.{key:09d}"


class FixedLenTok:
    """The JAX tools' ``_FixedLenTok`` (bench_vla_service.py:55,
    bench_rerank_stability.py:48): a fixed encode length, so every
    prompt has one (B, T) shape, and an injective decode to a decimal,
    so random weights give varied parsed scores."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def encode(self, text):
        ids = [b % (self.vocab - 8) + 3 for b in text.encode("utf-8")]
        ids = ids[:N_TEXT]
        return [1] + ids + [2] * (N_TEXT - 1 - len(ids))

    def decode(self, ids):
        return _hash_decimal(ids)


class AnyresTok:
    """The anyres tool's ``_Tok`` (bench_vla_anyres.py:45): 60 ids a
    prompt, the same injective decode."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def encode(self, text):
        ids = [b % (self.vocab - 8) + 3 for b in text.encode()][:59]
        return [1] + ids + [2] * (59 - len(ids))

    def decode(self, ids):
        return _hash_decimal(ids)


def device_stamp(dev) -> str:
    """What every record says it ran on: for a card, ``nvidia-smi``'s
    name and power limit (``--query-gpu=name,power.limit``); otherwise
    the device's name."""
    if dev.type != "cuda":
        return str(dev)
    index = dev.index if dev.index is not None else 0
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    """The barrier before a clock stops: on a card the host waits for
    every queued kernel (``torch.cuda.synchronize``)."""
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def timed(fn, dev) -> float:
    """Host-clock seconds of ``fn()`` with the device drained before the
    clock starts and before it stops."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return time.perf_counter() - t0


def event_ms(fn, dev, n: int = 1) -> float:
    """ms a call of ``fn`` over ``n`` calls back to back, the device
    drained before the first: on a card CUDA events recorded before the
    first call and after the last (the host waits for the second), which
    is the JAX tools' "dispatch n, fetch the last"; elsewhere the host
    clock."""
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


class Counts:
    """The kernel launches (``kernels.launch_counts``) and blocking host
    reads (``utils.device.host_reads``) made since it was created, as
    differences, so a caller's own counts run on undisturbed."""

    def __init__(self):
        from leafgrasp_tpu_torch.kernels import launch_counts
        from leafgrasp_tpu_torch.utils.device import host_reads
        self._launches, self._reads = launch_counts(), host_reads()

    def read(self):
        """({kernel: launches} of the kernels that launched, host reads)."""
        from leafgrasp_tpu_torch.kernels import launch_counts
        from leafgrasp_tpu_torch.utils.device import host_reads
        now = launch_counts()
        return ({k: v - self._launches[k] for k, v in now.items()
                 if v != self._launches[k]}, host_reads() - self._reads)


def one_call(fn, dev):
    """(record, result) of one call of ``fn`` between two barriers. The
    record: ``alone_ms`` (CUDA events on a card, the host clock
    elsewhere), ``host_ms`` (the host clock until ``fn`` returned: its
    dispatch and the waits of its host reads, without the device's tail),
    ``launches`` and ``host_reads`` of the call."""
    sync(dev)
    counts = Counts()
    events = None
    if dev.type == "cuda":
        import torch
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    if events:
        events[0].record()
    out = fn()
    host = (time.perf_counter() - t0) * 1e3
    alone = host
    if events:
        events[1].record()
        events[1].synchronize()
        alone = events[0].elapsed_time(events[1])
    launches, reads = counts.read()
    return {"alone_ms": alone, "host_ms": host, "launches": launches,
            "host_reads": reads}, out


def device_time(fn, dev) -> dict:
    """``busy_ms``, the device time of the kernels, copies and fills that
    one call of ``fn`` runs, and ``device_ops``, how many it ran, from
    ``torch.profiler``; both None off a card (not measured). Eight
    launches of torch's spin kernel open the profile and are left out: a
    profile late in a long process has been seen to lose its first
    records."""
    if dev.type != "cuda":
        return {"busy_ms": None, "device_ops": None}
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize(dev)
        fn()
        torch.cuda.synchronize(dev)
    evs = [ev for ev in prof.key_averages()      # device rows, lead-in out
           if ev.self_device_time_total > 0 and "spin_kernel" not in ev.key]
    return {"busy_ms": sum(ev.self_device_time_total for ev in evs) / 1e3,
            "device_ops": sum(ev.count for ev in evs)}


def device_mem_gb(dev):
    """(GiB, method): the caching allocator's bytes in use on a card, or
    (None, "unavailable") elsewhere."""
    if dev.type != "cuda":
        return None, "unavailable"
    import torch
    return round(torch.cuda.memory_allocated(dev) / 2 ** 30, 2), \
        "allocator_bytes_in_use"


def free_memory(dev) -> None:
    """Return what the tools freed to the card before the next build."""
    import gc
    gc.collect()
    if dev.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def git_rev() -> Optional[str]:
    """``git rev-parse --short HEAD`` of the repository, or None."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=10, cwd=ROOT).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None
