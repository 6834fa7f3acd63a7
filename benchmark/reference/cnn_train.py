"""The plain reference of the CNN's training step: the frozen
GraspPointCNN (``grasp_ref``, its gate's plain version) in train mode,
the masked pos-weighted BCE with logits, the clip at global norm and
Adam with the weight decay added to the gradient, written out in
float32 tensor arithmetic (no ``torch.optim``), step by step.

It follows the first steps of a run from the same drawn weights, the
same batches and the same dropout draws (torch's default generator
reseeded as the run reseeds it before its first step), and returns what
the comparison reads: each step's loss, the raw gradient and the
gradient Adam takes (clipped, with the decay) at step 1, and each
parameter's change over the steps.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.models.grasp_service import reference_cnn


def bce(logits, labels, pos_weight: float):
    logits, labels = logits.reshape(-1), labels.reshape(-1)
    per = -(pos_weight * labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    return per.mean()


def reference_steps(ref_cfg, state, batches, dropout_seed: int, dev,
                    tf32: bool = False) -> Dict:
    """Run ``len(batches)`` steps; ``tf32`` computes the products and
    convolutions in TF32 (the control)."""
    t = ref_cfg.train
    b1, b2, eps = 0.9, 0.999, 1e-8
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = reference_cnn(ref_cfg, state, dev, train=True)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        params = [p for n, p in model.named_parameters() if p.requires_grad]
        start = [p.detach().clone() for p in params]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        losses: List[float] = []
        out = {}
        torch.manual_seed(dropout_seed)
        for step, (x, y) in enumerate(batches, start=1):
            loss = bce(model(x), y, float(t.pos_weight))
            grads = torch.autograd.grad(loss, params)
            total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = min(1.0, float(t.grad_clip) / (float(total) + 1e-6))
            with torch.no_grad():
                taken = [g * scale + t.weight_decay * p
                         for g, p in zip(grads, params)]
                for i, (p, g) in enumerate(zip(params, taken)):
                    m[i] = b1 * m[i] + (1 - b1) * g
                    v[i] = b2 * v[i] + (1 - b2) * g * g
                    mhat = m[i] / (1 - b1 ** step)
                    vhat = v[i] / (1 - b2 ** step)
                    p -= t.learning_rate * mhat / (torch.sqrt(vhat) + eps)
            losses.append(loss.item())
            if step == 1:
                out["raw_grad"] = {n: g.detach().clone()
                                   for n, g in zip(names, grads)}
                out["taken_grad"] = dict(zip(names, taken))
        out["losses"] = losses
        out["change"] = {n: (p.detach() - p0)
                         for n, p, p0 in zip(names, params, start)}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep=None) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    names = [k for k in ref if keep is None or k in keep]
    vals = sorted(ref[k] for k in names)
    med = vals[len(vals) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap, as ``worst_leaf_gap`` takes the largest."""
    names = [k for k in ref if keep is None or k in keep]
    vals = sorted(ref[k] for k in names)
    med = vals[len(vals) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: the first step's relative loss gap, the
    worst leaf's gap of the step-1 gradient Adam took, and the median
    leaf's gap of the change over the steps, leaving out the leaves whose
    raw reference gradient is under a thousandth of the median leaf's (a
    bias that feeds a train-mode BatchNorm: nought to rounding). Beside
    them, not compared: the worst step's loss gap and the worst leaf's
    change gap. Adam's first steps move each element by about the
    learning rate whatever its gradient's size, so an element whose
    gradient is near nought moves one way or the other on rounding; the
    loss of the later steps and a small leaf's change carry that, and
    read from seed to seed as widely as TF32 does."""
    gaps_l = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"])]
    raw = leaf_norms(ref["raw_grad"])
    med = sorted(raw.values())[len(raw) // 2]
    keep = {k for k, v in raw.items() if v >= 1e-3 * med}
    grad = worst_leaf_gap(prog["taken_grad"], leaf_norms(ref["taken_grad"]))
    gaps = sorted(leaf_gaps(prog["change"], leaf_norms(ref["change"]),
                            keep).values())
    return {"loss1_rel": gaps_l[0], "loss_rel": max(gaps_l),
            "grad1_rel": grad,
            "change_med_rel": gaps[len(gaps) // 2],
            "change_worst_rel": gaps[-1],
            "leaves_left_out": float(len(raw) - len(keep))}
