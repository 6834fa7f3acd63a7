"""Self-supervised GraspPointCNN trainer, PyTorch port of
leafgrasp_tpu/training/train.py (reference train_model.py:155-394):
global z-score normalization (stats kept in the checkpoint), 80/20
random split, class-balanced sampling with replacement, pos-weighted
BCE-with-logits, gradient clipping at global norm 1.0, Adam with L2
folded into the gradient (``torch.optim.Adam(weight_decay=...)``, not
AdamW, as optax's ``add_decayed_weights`` before ``scale_by_adam``),
the plateau learning-rate cut and early stopping by the JAX package's
own loop, with the best weights restored.

Faithful to the JAX package:
* ``analyze_predictions`` thresholds *logits* at 0.5 by default (the
  reference's quirk, train_model.py:66); ``threshold=0.0`` is the
  calibrated p > 0.5 decision, tracked beside it;
* batches have a fixed size; the validation set is padded by resampling
  its first rows, with a validity mask.

The dataset lives on the device for the whole fit; loss accumulates on
the device, and an epoch reads back once (``utils.device.fetch_to_host``).

``Trainer(mesh=...)`` fits over a (data, model) mesh, one process a
rank (parallel/mesh.py), and computes what the single-process fit
computes at the same global batch: every rank draws the same epoch
sample and the same global dropout masks and takes its slice of the
batch; the loss is the global mean, the gradients are summed over
``data``, and the BatchNorm statistics are the global batch's (summed
over ``data``, as GSPMD takes them); with a model axis above 1 the
dense layers are column-sharded by parallel/sharding.py's rule.
Evaluation is replicated. A step's floats differ from the
single-process step's by the order of the sums only; over a fit Adam
carries such differences far beyond rounding, as it does when only the
order of the single-process fit's own sums changes.
Draws (split, sampling, dropout) come from torch generators seeded with
``TrainConfig.seed``, not JAX's PRNG, so a fit is not equal to the JAX
package's fit step for step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch.distributed.tensor import Shard

from leafgrasp_tpu_torch.config import ModelConfig, TrainConfig
from leafgrasp_tpu_torch.models.convert import grasp_cnn_flax_name
from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                  _FlaxBatchNorm,
                                                  init_like_flax_)
from leafgrasp_tpu_torch.parallel.collectives import Axis
from leafgrasp_tpu_torch.parallel.mesh import mesh_device
from leafgrasp_tpu_torch.parallel.sharding import (ColumnParallelLinear,
                                                   shard_variables)
from leafgrasp_tpu_torch.utils.device import fetch_to_host, resolve_device

__all__ = ["NormStats", "normalize_dataset", "bce_with_logits",
           "analyze_predictions", "make_optimizer", "optimizer_step",
           "make_train_step", "make_parallel_train_step",
           "parallelize_grasp_cnn", "gather_grasp_cnn",
           "GlobalBatchDropout", "make_eval_step", "PlateauSchedule",
           "Trainer", "TrainResult"]


class NormStats(NamedTuple):
    """Global z-score stats saved into checkpoints
    (train_model.py:41-62,328)."""
    depth_mean: torch.Tensor
    depth_std: torch.Tensor
    score_mean: torch.Tensor   # (7,) per-channel
    score_std: torch.Tensor    # (7,)


def normalize_dataset(depth_patches: torch.Tensor,
                      score_patches: torch.Tensor):
    """Global z-score of depth (scalar) and per-channel scores; the
    standard deviations are the population's, as ``jnp.std``."""
    depth_mean = depth_patches.mean()
    depth_std = depth_patches.std(correction=0)
    score_mean = score_patches.mean(dim=(0, 2, 3), keepdim=True)
    score_std = score_patches.std(dim=(0, 2, 3), correction=0,
                                  keepdim=True)
    stats = NormStats(depth_mean, depth_std, score_mean.reshape(-1),
                      score_std.reshape(-1))
    return ((depth_patches - depth_mean) / depth_std,
            (score_patches - score_mean) / score_std, stats)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    pos_weight: float, mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``BCEWithLogitsLoss(pos_weight=w)``, masked mean."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1)
    per = -(pos_weight * labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    if mask is None:
        return per.mean()
    mask = mask.reshape(-1).to(per.dtype)
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def analyze_predictions(logits: np.ndarray, labels: np.ndarray,
                        threshold: float = 0.5) -> Dict[str, Any]:
    """Reference metric block (train_model.py:64-100). NOTE: thresholds
    raw logits at 0.5, reproducing the reference's quirk (equivalent to
    p > 0.62); pass threshold=0.0 for the calibrated p > 0.5 decision."""
    predicted = (np.asarray(logits).reshape(-1) > threshold) \
        .astype(np.float32)
    labels = np.asarray(labels).reshape(-1)
    tp = int(((predicted == 1) & (labels == 1)).sum())
    tn = int(((predicted == 0) & (labels == 0)).sum())
    n_pos = int((labels == 1).sum())
    n_neg = int((labels == 0).sum())
    fp = n_neg - tn
    fn = n_pos - tp
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    return {
        "positive_accuracy": 100.0 * tp / n_pos if n_pos else 0.0,
        "negative_accuracy": 100.0 * tn / n_neg if n_neg else 0.0,
        "precision": precision * 100.0,
        "recall": recall * 100.0,
        "f1_score": f1 * 100.0,
        "confusion_matrix": {"true_positive": tp, "false_positive": fp,
                             "false_negative": fn, "true_negative": tn},
    }


def make_optimizer(model: torch.nn.Module,
                   cfg: TrainConfig) -> torch.optim.Adam:
    """optax's ``add_decayed_weights -> scale_by_adam -> -lr``: Adam
    (betas 0.9, 0.999, eps 1e-8) with the weight decay added to the
    gradient. The clip at global norm comes before it, in the train step.
    The learning rate changes through ``param_groups``."""
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def optimizer_step(optimizer: torch.optim.Optimizer, params,
                   cfg: TrainConfig) -> None:
    """optax's ``clip_by_global_norm(cfg.grad_clip)`` over all
    parameters' gradients, then one optimizer step (no host read)."""
    torch.nn.utils.clip_grad_norm_(params, cfg.grad_clip, foreach=True)
    optimizer.step()


def make_train_step(model: GraspPointCNN, optimizer: torch.optim.Optimizer,
                    cfg: TrainConfig):
    """``step(feats, labels, mask, pos_weight) -> (loss, correct)``, both
    0-dim tensors on the model's device (nothing is read back): one
    forward in train mode, the gradient, the clip at ``cfg.grad_clip``
    global norm, one optimizer step, in place."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(feats, labels, mask, pos_weight):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(feats)
        loss = bce_with_logits(logits, labels, pos_weight, mask)
        loss.backward()
        optimizer_step(optimizer, params, cfg)
        with torch.no_grad():
            hit = (torch.sigmoid(logits.reshape(-1)) > 0.5) \
                == (labels.reshape(-1) > 0.5)
            correct = (hit * mask.reshape(-1)).sum()
        return loss.detach(), correct
    return step


def make_eval_step(model: GraspPointCNN):
    """``step(feats, labels, mask, pos_weight) -> (loss, logits)`` in
    eval mode, without a graph."""

    @torch.no_grad()
    def step(feats, labels, mask, pos_weight):
        model.eval()
        logits = model(feats)
        return (bce_with_logits(logits, labels, pos_weight, mask),
                logits.reshape(-1))
    return step


class GlobalBatchDropout(torch.nn.Module):
    """``nn.Dropout`` for a data-parallel rank holding rows ``lo`` ... of a
    global batch of ``n_global``: it draws the whole batch's mask, as the
    single-process model's dropout does from the same generator state
    (same function, shape, memory format and device: the same draws, in
    memory order), and keeps its own rows."""

    def __init__(self, p: float, n_global: int, lo: int):
        super().__init__()
        self.p, self.n_global, self.lo = p, n_global, lo

    def forward(self, x):
        if not self.training:
            return x
        # the convolutions keep the NHWC input's channels-last layout
        fmt = torch.channels_last if x.dim() == 4 and not x.is_contiguous() \
            and x.is_contiguous(memory_format=torch.channels_last) \
            else torch.contiguous_format
        ones = torch.ones((self.n_global, *x.shape[1:]), dtype=x.dtype,
                          device=x.device).contiguous(memory_format=fmt)
        mask = F.dropout(ones, self.p, True)
        return x * mask[self.lo:self.lo + x.shape[0]]


def _replace_modules(model: torch.nn.Module, kind, make) -> None:
    """Replace every submodule of type ``kind`` by ``make(name, mod)``."""
    for name, mod in list(model.named_modules()):
        if isinstance(mod, kind):
            parent_name, _, leaf = name.rpartition(".")
            parent = model.get_submodule(parent_name)
            if isinstance(parent, torch.nn.ModuleList):
                parent[int(leaf)] = make(name, mod)
            else:
                setattr(parent, leaf, make(name, mod))


def parallelize_grasp_cnn(model: GraspPointCNN, mesh, batch_size: int):
    """The single-process model (on this rank's device, with the weights
    every rank holds) for the data-parallel fit over ``mesh``: global
    batch statistics and dropout masks over ``data``, and over ``model``
    the column-sharded dense layers of parallel/sharding.py's rule.
    Returns (model, the set of sharded ``state_dict`` keys, the slice of
    each global batch this rank takes)."""
    data, tp = Axis(mesh, "data"), Axis(mesh, "model")
    if batch_size % data.size:
        raise ValueError(f"batch size {batch_size} does not divide the "
                         f"data axis of {data.size}")
    n = batch_size // data.size
    lo = data.index * n
    if data.size > 1:
        for mod in model.modules():
            if isinstance(mod, _FlaxBatchNorm):
                mod.batch_axis = data
        _replace_modules(model, torch.nn.Dropout,
                         lambda _, d: GlobalBatchDropout(d.p, batch_size,
                                                         lo))
    sharded = set()
    if tp.size > 1:
        n_hidden = len(model.dense)
        local, placements = shard_variables(
            model.state_dict(), mesh,
            lambda key: grasp_cnn_flax_name(key, n_hidden))
        sharded = {k for k, p in placements.items()
                   if isinstance(p[1], Shard)}

        def column(name, lin):
            bias = local[f"{name}.bias"].to_local() \
                if lin.bias is not None else None
            return ColumnParallelLinear(
                local[f"{name}.weight"].to_local(), bias, tp)
        _replace_modules(model, torch.nn.Linear,
                         lambda name, lin: column(name, lin)
                         if f"{name}.weight" in sharded else lin)
    return model, sharded, slice(lo, lo + n)


def gather_grasp_cnn(model: torch.nn.Module, mesh, sharded: set,
                     model_cfg: ModelConfig) -> GraspPointCNN:
    """A plain GraspPointCNN in eval mode holding the full weights of a
    model that ``parallelize_grasp_cnn`` made (every rank gets them)."""
    tp = Axis(mesh, "model")
    state = {k: torch.cat(list(tp.gather(v)), dim=0) if k in sharded else v
             for k, v in model.state_dict().items()}
    dev = next(model.parameters()).device
    plain = GraspPointCNN(model_cfg).to(dev)
    plain.load_state_dict(state)
    return plain.eval()


def make_parallel_train_step(model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer,
                             cfg: TrainConfig, mesh, sharded: set):
    """``make_train_step`` for a model from ``parallelize_grasp_cnn``, fed
    this rank's slice of the global batch: the loss is this slice's share
    of the global mean; the gradients and the loss are summed over
    ``data`` in one collective; over ``model`` the replicated tensors'
    gradients and the loss are rank 0's (one broadcast); the clip's
    global norm counts each sharded dense layer's shards once (their
    squares summed over ``model``). Returns (global loss, None)."""
    data, tp = Axis(mesh, "data"), Axis(mesh, "model")
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [model.get_parameter(n) for n in names]
    is_sharded = [n in sharded for n in names]
    replicated = [i for i, sh in enumerate(is_sharded) if not sh]

    def step(feats, labels, mask, pos_weight):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(feats)
        loss = bce_with_logits(logits, labels, pos_weight, mask) / data.size
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        sizes = [g.numel() for g in grads]
        flat = data.sum(torch.cat([g.reshape(-1) for g in grads]
                                  + [loss.detach().reshape(1)]))
        parts, total = list(flat[:-1].split(sizes)), flat[-1]
        if tp.size > 1:
            # the model axis' ranks hold one replica of each replicated
            # tensor, but cuDNN's weight gradients may differ in their
            # last bits from rank to rank (atomic sums): all take rank
            # 0's, and its loss
            rep = tp.broadcast(torch.cat([parts[i] for i in replicated]
                                         + [total.reshape(1)]))
            for i, part in zip(replicated, rep[:-1].split(
                    [sizes[i] for i in replicated])):
                parts[i] = part
            total = rep[-1]
        for p, part in zip(params, parts):
            p.grad = part.view_as(p)
        if tp.size == 1:
            optimizer_step(optimizer, params, cfg)
        else:
            norms = torch.stack([torch.linalg.vector_norm(p.grad)
                                 for p in params]) ** 2
            flags = torch.tensor(is_sharded, device=norms.device)
            norm = torch.sqrt(norms[~flags].sum()
                              + tp.sum(norms[flags].sum()))
            coef = torch.clamp(cfg.grad_clip / (norm + 1e-6), max=1.0)
            torch._foreach_mul_([p.grad for p in params], coef)
            optimizer.step()
        return total, None
    return step


class PlateauSchedule:
    """The JAX package's hand loop (train.py:307-329), not torch's
    ``ReduceLROnPlateau`` (whose relative threshold of 1e-4 cuts at other
    epochs): the learning rate halves (``plateau_factor``, floor
    ``min_lr``) once ``wait > plateau_patience`` epochs passed without a
    strictly lower validation loss, and the wait restarts after a cut;
    training stops after ``early_stop_patience`` epochs without an
    improvement of more than ``early_stop_min_delta``."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.lr = cfg.learning_rate
        self.best = float("inf")
        self.wait = 0
        self.es_best = None
        self.es_wait = 0

    def step(self, val_loss: float):
        """-> (improved: a new best, stop: end training now)."""
        cfg = self.cfg
        improved = val_loss < self.best
        if improved:
            self.best = val_loss
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > cfg.plateau_patience:
                self.lr = max(self.lr * cfg.plateau_factor, cfg.min_lr)
                self.wait = 0
        stop = False
        if self.es_best is None \
                or val_loss < self.es_best - cfg.early_stop_min_delta:
            self.es_best = val_loss
            self.es_wait = 0
        else:
            self.es_wait += 1
            stop = self.es_wait >= cfg.early_stop_patience
        return improved, stop


@dataclasses.dataclass
class TrainResult:
    model: GraspPointCNN              # holds the best epoch's weights
    norm_stats: NormStats
    best_val_loss: float
    best_epoch: int
    metrics: Dict[str, Any]           # metrics at the best epoch
    history: Dict[str, list]
    final_metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    optimizer_state: Optional[Dict[str, Any]] = None


def _pad(arr: torch.Tensor, bs: int) -> torch.Tensor:
    """Pad to a multiple of ``bs`` by repeating the rows from the first
    on, cyclically (the JAX package's ``_pad`` takes ``arr[:pad]`` once,
    which falls short when fewer than ``bs / 2`` rows are given)."""
    n = arr.shape[0]
    pad = (-n) % bs
    if pad == 0:
        return arr
    return torch.cat([arr, arr[torch.arange(pad, device=arr.device) % n]])


def _batch_pad_mask(n: int, bs: int, device) -> torch.Tensor:
    pad = (-n) % bs
    return torch.cat([torch.ones(n, device=device),
                      torch.zeros(pad, device=device)])


class Trainer:
    """Host-side training loop (epochs, plateau learning rate, early
    stop) driving the train and eval steps on one device. ``device=None``
    means CUDA (raises if absent). With ``mesh`` (parallel.make_mesh)
    every rank of it calls ``fit`` with the same dataset and the fit is
    data- (and tensor-) parallel, on the mesh's device; every rank
    returns the same result, with the full weights."""

    def __init__(self, model_cfg: ModelConfig = ModelConfig(),
                 cfg: TrainConfig = TrainConfig(), device=None, mesh=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh_device(mesh)
            if device is not None and \
                    resolve_device(device).type != self.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{self.device}")

    def fit(self, dataset: Dict[str, np.ndarray],
            epochs: Optional[int] = None, log_fn=None) -> TrainResult:
        """dataset: depth_patches (N,P,P), mask_patches (N,P,P),
        score_patches (N,7,P,P), labels (N,)."""
        dev = self.device
        devices = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(self.cfg.seed)    # dropout's draws
            return self._fit(dataset, epochs or self.cfg.epochs, log_fn)

    def _fit(self, dataset, epochs: int, log_fn) -> TrainResult:
        cfg, dev = self.cfg, self.device

        def t(key):
            return torch.as_tensor(np.asarray(dataset[key], np.float32),
                                   device=dev)

        depth_n, score_n, norm_stats = normalize_dataset(
            t("depth_patches"), t("score_patches"))
        labels = t("labels")
        # NHWC features: depth, mask, 7 scores
        feats = torch.cat([depth_n[..., None], t("mask_patches")[..., None],
                           score_n.permute(0, 2, 3, 1)], dim=-1)

        n = feats.shape[0]
        gen_cpu = torch.Generator().manual_seed(cfg.seed)
        perm = torch.randperm(n, generator=gen_cpu).to(dev)
        n_train = int((1.0 - cfg.val_fraction) * n)
        tr_idx, va_idx = perm[:n_train], perm[n_train:]
        tr_feats, tr_labels = feats[tr_idx], labels[tr_idx]
        va_feats, va_labels = feats[va_idx], labels[va_idx]

        # class-balanced sampling weights (train_model.py:194-203)
        n_pos = torch.clamp((tr_labels == 1).sum(), min=1)
        n_neg = torch.clamp((tr_labels == 0).sum(), min=1)
        w = torch.where(tr_labels == 1, torch.ones_like(tr_labels),
                        (n_pos / n_neg).to(torch.float32))
        sample_p = w / w.sum()

        model = GraspPointCNN(self.model_cfg)
        init_like_flax_(model, gen_cpu)
        model.to(dev)
        bs = cfg.batch_size
        rows = slice(0, bs)     # this rank's rows of each batch
        if self.mesh is not None:
            model, sharded, rows = parallelize_grasp_cnn(model, self.mesh,
                                                         bs)
        optimizer = make_optimizer(model, cfg)
        if self.mesh is None:
            train_step = make_train_step(model, optimizer, cfg)
        else:
            train_step = make_parallel_train_step(model, optimizer, cfg,
                                                  self.mesh, sharded)
        eval_step = make_eval_step(model)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        steps = max(1, -(-n_train // bs))
        sched = PlateauSchedule(cfg)
        # as in JAX: without any improvement the initial weights return
        best_epoch, best_metrics = 0, {}
        best_state = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
        history = {"train_loss": [], "val_loss": [], "metrics": [],
                   "lr": []}
        final_metrics = {}

        n_va = va_feats.shape[0]
        va_mask = _batch_pad_mask(n_va, bs, dev)
        va_feats_p, va_labels_p = _pad(va_feats, bs), _pad(va_labels, bs)
        ones = torch.ones(rows.stop - rows.start, device=dev)
        va_labels_np = va_labels.cpu().numpy()
        pos_w = float(cfg.pos_weight)
        for epoch in range(epochs):
            lr = sched.lr
            for group in optimizer.param_groups:
                group["lr"] = lr
            # with-replacement class-balanced sampling for the whole epoch
            idx = torch.multinomial(sample_p, steps * bs, replacement=True,
                                    generator=gen)
            ep_loss = torch.zeros((), device=dev)
            for s in range(steps):
                b = idx[s * bs:(s + 1) * bs][rows]
                loss, _ = train_step(tr_feats[b], tr_labels[b], ones, pos_w)
                ep_loss = ep_loss + loss

            # validation over padded fixed-size batches
            val_losses, val_logits = [], []
            for s in range(va_feats_p.shape[0] // bs):
                sl = slice(s * bs, (s + 1) * bs)
                loss, logits = eval_step(va_feats_p[sl], va_labels_p[sl],
                                         va_mask[sl], pos_w)
                val_losses.append(loss)
                val_logits.append(logits)
            ep_np, val_np, logits_np = fetch_to_host(
                (ep_loss, torch.stack(val_losses).mean(),
                 torch.cat(val_logits)))
            train_loss = float(ep_np) / steps
            val_loss = float(val_np)
            logits_all = logits_np[:n_va]
            metrics = dict(analyze_predictions(logits_all, va_labels_np))
            # calibrated decision boundary (p > 0.5 <=> logit > 0)
            metrics["calibrated"] = analyze_predictions(
                logits_all, va_labels_np, threshold=0.0)
            final_metrics = metrics

            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            history["metrics"].append(metrics)
            history["lr"].append(lr)
            if log_fn:
                log_fn(epoch=epoch, train_loss=train_loss,
                       val_loss=val_loss, lr=lr, **{
                           k: metrics[k] for k in
                           ("positive_accuracy", "negative_accuracy",
                            "f1_score")})

            improved, stop = sched.step(val_loss)
            if improved:
                best_epoch, best_metrics = epoch, metrics
                best_state = {k: v.detach().clone()
                              for k, v in model.state_dict().items()}
            if stop:
                break

        model.load_state_dict(best_state)
        model.eval()
        if self.mesh is not None:
            model = gather_grasp_cnn(model, self.mesh, sharded,
                                     self.model_cfg)
        return TrainResult(model=model, norm_stats=norm_stats,
                           best_val_loss=sched.best,
                           best_epoch=best_epoch,
                           metrics=best_metrics or final_metrics,
                           final_metrics=final_metrics, history=history,
                           optimizer_state=optimizer.state_dict())
