#!/usr/bin/env python3
"""Weight-only int8 / int4 VLA serving A/B at LLaVA widths on one GPU, on
the PyTorch port (vla/quant.py): the counterpart of
tools/bench_vla_quant.py.

In one process, bf16 first (then freed), then the quantized model:

  * the decode step at batch 5 (ms a step, ``_generate_decode_step``);
  * the batched 5-candidate rerank (prefill of 576 image + 60 text tokens
    and a 10-token greedy decode);
  * the quantized model's rerank once more with ``decode_mode="scan"``
    (the same route here: on the card the decode graph; a failure
    raises);
  * the weights' resident memory (``torch.cuda.memory_allocated`` after
    the build, less what was allocated before it).

Each time is the host clock around the work with the card drained before
and after (the JSON's ``*_ms``, best of three), and beside it CUDA
events around the same device work (printed on each line). Weights are
drawn directly in their serving types on the device: random int8 codes
(int4: random bytes, two nibbles each) with scales of the bf16 draw's
magnitude. torch has no int4 type, so ``--storage native`` and
``packed`` both hold int4 as nibble pairs in int8 (the JAX package's
packed form); the flag only names the record's keys as the JAX tool
does.

    python tools/bench_vla_quant_torch.py [--layers 16 --hidden 2048]
        [--full] [--bits 8|4] [--storage native|packed] [--skip-bf16]
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from tools._torch_bench import device_stamp, free_memory, sync  # noqa: E402
from tools._torch_eval import add_device_arg, setup_device  # noqa: E402


def _allocated(dev) -> int:
    import torch
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def build_quant(cfg, seed: int = 0, device=None):
    """A quantized model of ``cfg`` drawn directly in its serving types on
    ``device``: each language-model projection's codes uniform in
    [-qmax, qmax] (int8: 127; int4: packed bytes in [-127, 127], two
    random nibbles) with every scale 0.02 * 3.5 / qmax (the bf16 draw's
    largest magnitude), everything else as ``bench_vla_torch.build``
    draws it (bf16)."""
    import torch
    from leafgrasp_tpu_torch.utils.device import resolve_device
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     iter_random_llava_state)
    from leafgrasp_tpu_torch.vla.quant import is_quantized_weight
    from tools.bench_vla_torch import _newline_
    dev = resolve_device(device)
    bits, group = cfg.quant_bits, cfg.quant_group
    qmax = 127 if bits == 8 else 7
    code_max = 127          # int4 bytes carry two random nibbles
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = {}
    for key, t in iter_random_llava_state(
            dataclasses.replace(cfg, quantized=False), gen, dev,
            torch.bfloat16):
        if not is_quantized_weight(key):
            state[key] = t
            continue
        n_out, n_in = t.shape
        del t
        rows = n_in if bits == 8 else n_in // 2
        scale_shape = (n_out,) if bits == 8 else (n_in // group, n_out)
        prefix = key[:-len("weight")]
        state[prefix + "kernel_q"] = torch.randint(
            -code_max, code_max + 1, (rows, n_out), generator=gen,
            device=dev, dtype=torch.int8)
        state[prefix + "kernel_scale"] = torch.full(
            scale_shape, 0.02 * 3.5 / qmax, device=dev)
    model = LlavaTorch.from_state(dataclasses.replace(cfg, quantized=True),
                                  state)
    _newline_(model)
    return model


def model_config(full: bool, layers: int, hidden: int):
    """The bf16 config of the A/B (bench_vla_quant.py:161-170): the 7B
    widths with ``full``, else ``hidden`` wide and ``layers`` deep with
    128-wide heads, a K/V head to four query heads and a 2-layer tower."""
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorchConfig
    if full:
        return LlavaTorchConfig(dtype="bfloat16")
    return LlavaTorchConfig(dtype="bfloat16", hidden=hidden,
                            intermediate=int(3.5 * hidden), layers=layers,
                            heads=hidden // 128,
                            kv_heads=max(1, hidden // 512), vis_layers=2)


def _timer(dev):
    """(start, stop) of a region: host clock with the card drained, and
    CUDA events on the card; stop returns (wall s, device s or None)."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
        if dev.type == "cuda" else None
    box = {}

    def start():
        sync(dev)
        if ev:
            ev[0].record()
        box["t0"] = time.perf_counter()

    def stop():
        if ev:
            ev[1].record()
        sync(dev)
        wall = time.perf_counter() - box["t0"]
        return wall, (ev[0].elapsed_time(ev[1]) / 1e3 if ev else None)

    return start, stop


def _best(pairs):
    """(best wall, best device) over (wall, device) readings."""
    dev_t = [d for _, d in pairs if d is not None]
    return min(w for w, _ in pairs), (min(dev_t) if dev_t else None)


def time_steps_decode(model, b, t, dev, steps=32):
    """(wall s, device s) a step of the per-token decode at batch ``b``
    after a ``t``-token prompt: ``steps - 1`` chained steps, best of 3."""
    import torch
    from leafgrasp_tpu_torch.vla.layers import KVCache
    from leafgrasp_tpu_torch.vla.llava_torch import (_generate_decode_step,
                                                     _generate_prefill)
    n_new = steps + 1
    ids = torch.full((b, t), 7, dtype=torch.long, device=dev)
    pad = torch.zeros((b,), dtype=torch.int32, device=dev)
    prompt_len = torch.full((), t, dtype=torch.int64, device=dev)

    def prefill():
        cache = KVCache(model.cfg, b, t + n_new, dev)
        return _generate_prefill(model, ids, pad, None, None, cache)[0], \
            cache

    last, cache = prefill()
    _generate_decode_step(model, cache, last, pad, 0, prompt_len)
    start, stop = _timer(dev)
    out = []
    for _ in range(3):
        last, cache = prefill()
        start()
        for i in range(1, steps):
            last = _generate_decode_step(model, cache, last, pad, i,
                                         prompt_len)
        wall, dev_s = stop()
        out.append((wall / (steps - 1),
                    None if dev_s is None else dev_s / (steps - 1)))
    return _best(out)


def time_rerank(model, dev, n_cand=5, n_new=10, decode_mode="steps"):
    """(wall s, device s) of the batched ``n_cand`` rerank: prefill (the
    image tokens and 60 text tokens) and an ``n_new``-token greedy
    decode, best of 3 after one warm-up."""
    import torch
    from leafgrasp_tpu_torch.vla.llava_torch import greedy_generate_llava
    cfg = model.cfg
    n_img = cfg.num_patches
    ids = np.full((n_cand, 60 + n_img), 7, np.int64)
    ids[:, 2:2 + n_img] = cfg.image_token_index
    ids = torch.as_tensor(ids).to(dev)
    px = torch.zeros((n_cand, cfg.image_size, cfg.image_size, 3),
                     device=dev)
    pad = torch.zeros((n_cand,), dtype=torch.int32, device=dev)

    def gen():
        return greedy_generate_llava(model, ids, pixel_values=px,
                                     max_new_tokens=n_new, pad_lens=pad,
                                     decode_mode=decode_mode)

    gen()
    start, stop = _timer(dev)
    out = []
    for _ in range(3):
        start()
        gen()
        out.append(stop())
    return _best(out)


def _ms(pair) -> str:
    wall, dev_s = pair
    dev_txt = "not measured" if dev_s is None else f"{dev_s * 1e3:.3f} ms"
    return f"{wall * 1e3:8.3f} ms (CUDA events {dev_txt})"


def main(argv=None):
    """Run the A/B; returns the JSON record it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--bits", type=int, default=8, choices=(8, 4),
                    help="weight-only quantization width for phase B")
    ap.add_argument("--storage", choices=("native", "packed"),
                    default="native",
                    help="int4 storage name (both are nibble pairs here)")
    ap.add_argument("--skip-bf16", action="store_true",
                    help="skip phase A (bf16)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = setup_device(args.device)

    import torch
    from tools.bench_vla_torch import build

    base_cfg = model_config(args.full, args.layers, args.hidden)
    qcfg = dataclasses.replace(base_cfg, quantized=True,
                               quant_bits=args.bits)
    b, t = args.batch, 64
    packed = args.bits == 4 and args.storage == "packed"
    qn = f"int{args.bits}" + ("p" if packed else "")
    res, dev_res = {}, {}

    def weights_gb(before):
        return round((_allocated(dev) - before) / 2 ** 30, 3) \
            if dev.type == "cuda" else None

    def run(tag, model, base_bytes):
        res[f"{tag}_weights_gb"] = weights_gb(base_bytes)
        print(f"{tag}  weights resident: {res[f'{tag}_weights_gb']} GiB",
              flush=True)
        pair = time_steps_decode(model, b, t, dev)
        res[f"{tag}_step_ms"], dev_res[f"{tag}_step_ms"] = pair
        print(f"{tag}  steps-decode B={b}: {_ms(pair)} /step", flush=True)
        pair = time_rerank(model, dev, n_cand=b)
        res[f"{tag}_rerank_ms"], dev_res[f"{tag}_rerank_ms"] = pair
        print(f"{tag}  batched {b}-cand rerank: {_ms(pair)} /frame",
              flush=True)

    with torch.no_grad():
        if not args.skip_bf16:
            before = _allocated(dev)
            model = build(base_cfg, device=dev)
            run("bf16", model, before)
            del model
            free_memory(dev)

        before = _allocated(dev)
        qmodel = build_quant(qcfg, device=dev)
        run(qn, qmodel, before)
        pair = time_rerank(qmodel, dev, n_cand=b, decode_mode="scan")
        res[f"{qn}_rerank_scan_ms"], dev_res[f"{qn}_rerank_scan_ms"] = pair
        print(f"{qn}  batched rerank, scan decode: {_ms(pair)} /frame",
              flush=True)
        del qmodel
        free_memory(dev)

    if not args.skip_bf16:
        res["step_speedup"] = round(res["bf16_step_ms"]
                                    / res[f"{qn}_step_ms"], 3)
        res["rerank_speedup"] = round(res["bf16_rerank_ms"]
                                      / res[f"{qn}_rerank_ms"], 3)
    rec = {
        "metric": f"vla_serving_{qn}_ab",
        **{k: (round(v * 1e3, 3) if k.endswith("_ms")
               and isinstance(v, float) else v)
           for k, v in res.items()},
        "dims": {"hidden": base_cfg.hidden, "layers": base_cfg.layers,
                 "batch": b, "full": args.full},
        "device": device_stamp(dev),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
