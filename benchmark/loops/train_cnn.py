"""The CNN's training step back to back: ``training/train.py``'s
``make_train_step`` at the configuration's ``TrainConfig`` with
``make_optimizer``, fed as ``Trainer`` feeds it (class-balanced draws
with replacement, a whole epoch's indices drawn at once) from a corpus
drawn on the card from the seed; the loss and accuracy are read once an
epoch, as ``Trainer`` reads them.

Set-up builds one step object and drives it through its first
``check_steps`` steps on batches whose rows all differ, with torch's
default generator (the dropout draws) seeded from the seed; the window
goes on with that same object. The reference follows those first steps
(``reference/cnn_train.py``). The window ends with the first step that
is enqueued after ``--seconds``, and the card is synchronized before its
clock stops. In every run one more epoch of steps (``trace_steps``)
runs after it under the profiler: the card's busy time a step is an
end-to-end reading of this cell, the rest of the trace per-layer.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark.core import host, work
from benchmark.core.record import Limit, Run
from benchmark.core.trace import Tracer, span
from benchmark.models import grasp_service as grasp
from benchmark.reference import cnn_train


def corpus(traffic: dict, in_channels: int, seed: int, dev):
    """(features (N, P, P, C), labels (N,)) float32 on ``dev``: depth and
    score channels standard normal, the mask channel 0/1, labels 1 with
    the mix's ``positive_share``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n, p = int(traffic["corpus"]), int(traffic["patch"])
    feats = torch.randn((n, p, p, in_channels), generator=gen, device=dev)
    feats[..., 1] = (feats[..., 1] > 0).to(torch.float32)
    labels = (torch.rand((n,), generator=gen, device=dev)
              < float(traffic["positive_share"])).to(torch.float32)
    return feats, labels


class Epochs:
    """Trainer's feed: each epoch's indices drawn at once from the
    class-balanced weights; the epoch's summed loss and correct count
    read back once, at its end."""

    def __init__(self, feats, labels, bs: int, gen):
        self.feats, self.labels, self.bs, self.gen = feats, labels, bs, gen
        n_pos = torch.clamp((labels == 1).sum(), min=1)
        n_neg = torch.clamp((labels == 0).sum(), min=1)
        w = torch.where(labels == 1, torch.ones_like(labels),
                        (n_pos / n_neg).to(torch.float32))
        self.p = w / w.sum()
        self.steps = max(1, -(-labels.shape[0] // bs))
        self.s = self.steps
        self.idx = None
        self.loss = self.correct = None
        self.read = []

    def batch(self):
        if self.s == self.steps:
            self.end_epoch()
            self.idx = torch.multinomial(self.p, self.steps * self.bs,
                                         replacement=True,
                                         generator=self.gen)
            self.s = 0
        b = self.idx[self.s * self.bs:(self.s + 1) * self.bs]
        self.s += 1
        return self.feats[b], self.labels[b]

    def add(self, loss, correct):
        self.loss = loss if self.loss is None else self.loss + loss
        self.correct = correct if self.correct is None \
            else self.correct + correct

    def end_epoch(self):
        if self.loss is not None:
            from leafgrasp_tpu_torch.utils.device import fetch_to_host
            with span("epoch_read"):
                self.read.append(fetch_to_host((self.loss, self.correct)))
            self.loss = self.correct = None


class Setup:
    """One step object, driven through its first ``check_steps`` steps on
    batches whose rows all differ, the dropout draws from the seed; what
    the program read from them (``prog``) and what the reference needs
    to follow them."""

    def __init__(self, cell, seed: int, dev, overrides: dict):
        from leafgrasp_tpu_torch import config as pconfig
        from leafgrasp_tpu_torch.training.train import (make_optimizer,
                                                        make_train_step)
        config, traffic = cell.config, dict(cell.traffic, **overrides)
        self.config, self.traffic, self.dev = config, traffic, dev
        self.overrides = overrides
        cfg = grasp.pipeline_config(config, pconfig, overrides)
        tcfg = cfg.train
        self.state = grasp.cnn_state(cfg, seed, dev)
        self.model = grasp.program_cnn(cfg, self.state, dev, train=True)
        self.optimizer = make_optimizer(self.model, tcfg)
        step = make_train_step(self.model, self.optimizer, tcfg)
        feats, labels = corpus(traffic, cfg.model.in_channels, seed, dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed + 1)
        perm = torch.randperm(feats.shape[0], generator=self.gen,
                              device=dev)
        n_train = int((1.0 - float(traffic["val_fraction"]))
                      * feats.shape[0])
        self.tr_x, self.tr_y = feats[perm[:n_train]], labels[perm[:n_train]]
        self.bs = bs = int(tcfg.batch_size)
        ones = torch.ones(bs, device=dev)
        pos_w = float(tcfg.pos_weight)

        def one(x, y):
            with span("train_step"):
                return step(x, y, ones, pos_w)
        self.one = one
        n_check = int(traffic["check_steps"])
        self.batches = [(self.tr_x[k * bs:(k + 1) * bs],
                         self.tr_y[k * bs:(k + 1) * bs])
                        for k in range(n_check)]
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        start = {n: p.detach().clone() for n, p in named}
        self.dropout_seed = seed % (2 ** 63)
        torch.manual_seed(self.dropout_seed)
        prog = {"losses": []}
        for k, (x, y) in enumerate(self.batches):
            loss, _ = one(x, y)
            prog["losses"].append(loss)
            if k == 0:
                st = self.optimizer.state
                # a step that left no moments took no gradient
                prog["taken_grad"] = {n: float(torch.linalg.vector_norm(
                    st[p]["exp_avg"].double() / (1 - 0.9)))
                    if "exp_avg" in st.get(p, {}) else 0.0
                    for n, p in named}
        prog["change"] = {n: float(torch.linalg.vector_norm(
            (p.detach() - start[n]).double())) for n, p in named}
        prog["losses"] = [float(v) for v in prog["losses"]]
        self.prog = prog

    def reference(self, batches=None, tf32: bool = False) -> dict:
        from benchmark.reference.grasp_ref import config as rconfig
        ref_cfg = grasp.pipeline_config(self.config, rconfig,
                                        self.overrides)
        return cnn_train.reference_steps(
            ref_cfg, self.state, batches or self.batches,
            self.dropout_seed, self.dev, tf32=tf32)

    def release(self):
        del self.model, self.optimizer


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        overrides: dict) -> Run:
    su = Setup(cell, seed, dev, overrides)
    config, traffic, bs, one = su.config, su.traffic, su.bs, su.one
    tr_x, tr_y, gen = su.tr_x, su.tr_y, su.gen

    epochs = Epochs(tr_x, tr_y, bs, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    # the set-up's objects out of the collector's way for the window
    gc.collect()
    gc.freeze()
    host0 = host.snapshot()
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    deadline = t_win + seconds
    steps = 0
    while True:
        loss, correct = one(*epochs.batch())
        epochs.add(loss, correct)
        steps += 1
        if time.perf_counter() >= deadline:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t_win
    host_facts = host.window_facts(host0, host.snapshot())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0

    # the profiled tail runs in every run, after the window's clock
    n_traced = int(traffic["trace_steps"])
    with Tracer() as tracer:
        for _ in range(n_traced):
            epochs.add(*one(*epochs.batch()))
    summary = tracer.reduce(n_traced)
    counts = {"train_flop": n_traced * work.cnn_train_step_flop(
                  config["pipeline"]["model"], bs, int(traffic["patch"])),
              "train_dtype": config["precision"]}
    epochs.end_epoch()
    finite = all(torch.isfinite(torch.as_tensor(l)).all()
                 for l, _ in epochs.read)

    def check():
        su.release()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        got = cnn_train.compare(su.prog, su.reference())
        facts["leaves_left_out"] = got["leaves_left_out"]
        facts["change_worst_rel"] = got["change_worst_rel"]
        facts["loss_rel"] = got["loss_rel"]
        lim = cell.limits
        return [Limit("nonfinite_epoch_loss", float(not finite), 0.0),
                Limit("loss1_rel", got["loss1_rel"], lim["loss1_rel"]),
                Limit("grad1_rel", got["grad1_rel"], lim["grad1_rel"]),
                Limit("change_med_rel", got["change_med_rel"],
                      lim["change_med_rel"])]

    facts = {"steps": float(steps), "window_s": window_s,
             "epochs_read": float(len(epochs.read)), **host_facts}
    return Run(kind="train", setup_s=setup_s, window_s=window_s,
               attempted=steps, failed=0, memory_peak_bytes=int(peak),
               steps=steps, trace=summary, work=counts, check=check,
               facts=facts)
