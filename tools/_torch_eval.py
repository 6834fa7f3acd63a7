"""Shared pieces of the port's evaluation, parity and training tools
(``tools/*_torch.py``): the JAX tools' camera and paths, the device
set-up, the published message's parity rule, the row comparison against
a committed record, the shipped CNN and VLA scorer loaded into the port,
the training tools' fit-and-save, and the JSON output. Imports numpy and
the standard library at the top, torch and the port's modules inside the
functions that need them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "artifacts_torch")
# the leaf_grasp_node_v3 camera (parity_report.py PRODUCTION, the evals)
CAMERA = (707.87, 494.07, 1750.68)
TORCH_CNN = os.path.join(ROOT, "artifacts", "torch", "grasp_cnn",
                         "best_model")
TORCH_CNN_HARD = os.path.join(ROOT, "artifacts", "torch", "grasp_cnn_hard",
                              "best_model")
VLA_DIR = os.path.join(ROOT, "artifacts", "vla")
# the tiny LLaVA-architecture config tools/train_llava_lora.py pretrains
# (tools/eval_vla_system.py:44-47; must match the shipped npz files)
ARCH = dict(vis_hidden=64, vis_intermediate=128, vis_layers=2,
            vis_heads=4, image_size=28, patch_size=14, vocab_size=272,
            hidden=128, intermediate=256, layers=3, heads=4,
            kv_heads=2, image_token_index=264)


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without it)")


def setup_device(device=None):
    """The tools' device (None means CUDA; raises without it). On the
    card the convolutions and matrix products run in full f32, TF32 off,
    as on the CPU and as the JAX records were computed."""
    import torch
    from leafgrasp_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def repo_path(path: str) -> str:
    """A path as given, or relative to the repository's root."""
    return path if os.path.isabs(path) else os.path.join(ROOT, path)


def write_json(path: str, obj) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
    return path


def print_summary(summary: Dict, drop: Sequence[str] = ("rows",)) -> None:
    """The tool's last stdout line: the summary without its rows."""
    print(json.dumps({k: v for k, v in summary.items() if k not in drop}),
          flush=True)


def message_match(a: str, b: str) -> bool:
    """The JAX parity rule for two published messages
    (tools/parity_report.py:168-180): the pixel equal, every float within
    1e-5 relative (the reference lifts in float64 of f32 depth)."""
    x = [float(t) for t in a.split(",")]
    y = [float(t) for t in b.split(",")]
    return len(x) == len(y) and all(
        (p == q) if i < 2 else abs(p - q) <= 1e-5 * max(1.0, abs(p))
        for i, (p, q) in enumerate(zip(x, y)))


def compare_rows(got: List[Dict], want: Iterable[Dict],
                 seeds: Iterable[int], equal: Sequence[str],
                 close: Sequence[str] = (), tol: float = 0.0) -> List[Dict]:
    """Each mismatch between this run's rows and a record's, keyed by
    ``seed``: a row on one side only (among ``seeds``, the scenes this
    run drew), a field of ``equal`` that differs, or one of ``close``
    further apart than ``tol`` (None only against None)."""
    seeds = set(seeds)
    ref = {r["seed"]: r for r in want if r["seed"] in seeds}
    mine = {r["seed"]: r for r in got if r["seed"] in seeds}
    out = []
    for seed in sorted(set(ref) | set(mine)):
        if seed not in ref or seed not in mine:
            out.append({"seed": seed, "field": "row",
                        "ours": seed in mine, "record": seed in ref})
            continue
        a, b = mine[seed], ref[seed]
        for key in equal:
            if _plain(a.get(key)) != _plain(b.get(key)):
                out.append({"seed": seed, "field": key,
                            "ours": a.get(key), "record": b.get(key)})
        for key in close:
            x, y = a.get(key), b.get(key)
            if (x is None) != (y is None) or \
                    (x is not None and abs(x - y) > tol):
                out.append({"seed": seed, "field": key, "ours": x,
                            "record": y})
    return out


def _plain(v):
    """JSON's view of a value: tuples as lists."""
    return [_plain(x) for x in v] if isinstance(v, (list, tuple)) else v


def load_cnn(path: Optional[str], model_cfg, device,
             random_init: bool = False):
    """The GraspPointCNN of a port checkpoint (``training/checkpoint.py``
    format) on ``device``, in eval mode: ``(model, norm_stats, source)``.
    A missing or unreadable checkpoint raises; seeded weights (seed 0)
    only when ``random_init`` asks for them."""
    from leafgrasp_tpu_torch.models.predictor import GraspQualityPredictor
    pred = GraspQualityPredictor(model_cfg, device=device)
    if random_init:
        return pred.model, None, "random-init"
    pred.load(path)
    return pred.model, pred.norm_stats, os.path.relpath(path, ROOT)


def render_rgb(mask: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """Deterministic RGB composite: per-leaf palette + depth shading
    (tools/eval_vla_system.py:76-86)."""
    rng = np.random.default_rng(7)
    palette = rng.integers(40, 220, (int(mask.max()) + 1, 3))
    palette[0] = (12, 10, 8)
    rgb = palette[mask]
    d = depth - depth.min()
    shade = 0.55 + 0.45 * (1.0 - d / max(float(d.max()), 1e-6))
    return np.clip(rgb * shade[..., None], 0, 255).astype(np.uint8)


def load_arch_scorer(vla_dir: str, device, max_new_tokens: int = 6):
    """The trained LLaVA-arch LoRA scorer of ``vla_dir``: the pretrained
    base (``llava_arch_base.npz``) in the frozen slots and the adapter
    (``llava_arch_adapter.npz``) over it, as ``LlavaTorchScorer`` on
    ``device`` with the byte tokenizer."""
    import torch
    from leafgrasp_tpu_torch.vla.convert import flax_to_torch_llava
    from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     attach_lora)
    from leafgrasp_tpu_torch.vla.lm import ByteTokenizer
    from leafgrasp_tpu_torch.vla.lora import merge_lora_params
    dev = setup_device(device)
    base = np.load(os.path.join(vla_dir, "llava_arch_base.npz"))
    adapter = np.load(os.path.join(vla_dir, "llava_arch_adapter.npz"))
    model = LlavaTorch(LlavaTorchConfig(**ARCH, lora_rank=8,
                                        lora_alpha=16.0), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    attach_lora(model, merge_lora_params(flax_to_torch_llava(base),
                                         flax_to_torch_llava(adapter)), gen)
    return LlavaTorchScorer(model.eval(), ByteTokenizer(),
                            max_new_tokens=max_new_tokens)


def _log_epoch(**kw) -> None:
    """The JAX training tools' per-epoch line."""
    print(f"epoch {kw['epoch']:3d} train {kw['train_loss']:.4f} "
          f"val {kw['val_loss']:.4f} f1 {kw['f1_score']:.1f} "
          f"pos {kw['positive_accuracy']:.1f} "
          f"neg {kw['negative_accuracy']:.1f}", flush=True)


def load_corpus(path: str) -> Dict[str, np.ndarray]:
    """A collector's ``training_data.npz``, every array in memory."""
    with np.load(repo_path(path)) as data:
        return {k: data[k] for k in data.files}


def fit_and_save(trainer, data: Dict[str, np.ndarray], out_dir: str,
                 epochs: Optional[int] = None, info: Optional[Dict] = None
                 ) -> Dict:
    """``trainer.fit`` on a verified corpus, then what the JAX training
    tools write under ``out_dir``: ``best_model`` (the port's checkpoint
    format) with its ``.meta.json``, ``metrics.json`` (with ``info``
    merged in) and, where matplotlib is installed, the dashboard PNG.
    Returns the metrics record."""
    from leafgrasp_tpu_torch.training import (plot_metrics,
                                              save_checkpoint,
                                              verify_dataset)
    from leafgrasp_tpu_torch.training.checkpoint import best_model_path
    report = verify_dataset(data)
    if not report["ok"]:
        raise ValueError(f"corpus fails verification: {report['problems']}")
    print(f"dataset: {report['num_samples']} samples "
          f"({report['positive']} pos / {report['negative']} neg)",
          flush=True)
    result = trainer.fit(data, epochs=epochs, log_fn=_log_epoch)
    path = save_checkpoint(best_model_path(out_dir),
                           result.model.state_dict(),
                           norm_stats=result.norm_stats,
                           metrics=result.metrics, history=result.history,
                           epoch=result.best_epoch)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed: no dashboard", flush=True)
    else:
        plot_metrics(result.history, out_dir)
    record = {"best_val_loss": result.best_val_loss,
              "best_epoch": result.best_epoch, **(info or {}),
              "metrics": result.metrics, "samples": report["num_samples"],
              "epochs_run": len(result.history["train_loss"]),
              "device": str(trainer.device), "checkpoint": path}
    write_json(os.path.join(out_dir, "metrics.json"), record)
    print("final metrics:", result.metrics, flush=True)
    print("checkpoint written to", out_dir, flush=True)
    return record
