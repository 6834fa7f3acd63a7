#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phase 15]

Phases, each a hard failure (non-zero exit):

1. build the seven CUDA sources (the nine TPU kernels' counterparts and
   the attention gate's gradient) from ``leafgrasp_tpu_torch/kernels/csrc``
   into ``build/kernels/`` (one ``nvcc`` per source, all started
   together);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: fused scoring at 1080 x 1440 (max abs diff
   <= 1e-5, valid mask equal), the attention gate at (20, 16, 256) in all
   four modes and at the other architectures' shapes and the kernel's
   limits, from a contiguous input, from the NCHW view the CNN passes and
   from other strides (<= 1e-5), the min-plus in its full, window,
   sampled, refinement and banded forms, with a source sub-range, and at
   the edge of its expanded form's range (sentinel and largest admitted
   rows, sources at both ends of the row), then in its direct form on
   2100 x 1600, 2048 x 2448 and 2160 x 3840 frames, on a seedless field
   and a source sub-range without a seed (the sentinel, past 2^24,
   everywhere) and at the old edge of that form, and in its expanded
   form on a 1080 x 1920 frame, all bit-exact, the row-banded EDT at
   (1, 540, 720), (1, 540, 960) and (3, 1080, 1440) (bit-exact, radii
   included), and the segment histogram at 1080 x 1440 with 18 segments
   at one and two brackets, at a ragged size, from an offset view and
   with ids out of range (counts equal; the histogram median, two
   launches, within range / 256^2 of the sorted median), and the
   flash-attention prefill in f32 (<= 2e-5 on real rows) and bf16
   (<= 2^-6 of the value plus 2^-6 of the largest value of its output row) with unequal left pads at (2, 200, 4 heads over 2, 64),
   (5, 640, 32 over 8, 128), the serving shape (5, 2400, 32 over 8,
   128), a prompt shorter than one tile with one query head a K/V head,
   a pad that ends inside a 64-row group, and t = 2437 (no multiple of a
   tile), every cache holding NaN beyond t; pad rows exactly zero;
3. drive ``make_frame_fn(with_cnn=True)`` at 1080 x 1440 with the
   standard CNN (seeded weights) on the three ``bench.py`` scene families
   in the ``reference_self``, ``union`` and ``union_half`` modes, and in
   ``union_half`` once more with ``hist_median=True`` (the medians of
   leaf selection through the histogram kernel), with every launch
   count and the host-read count set to 0 just before and read just
   after; then hold the first frame of each family and variant against
   the port's own CPU path built the same way (same leaf id and grasp
   pixel), and the ``hist_median`` frames against the default's (same
   leaf, same tall leaves, same pixel); then one 1080 x 1920 frame in
   each isolation mode on the card against the CPU path (same leaf,
   pixel and flag, phase 3c), and one 2048 x 2448 frame (5 MP) in the
   ``union`` mode (phase 3d), whose min-plus runs in its direct form;
4. profile one frame per mode (``torch.profiler``): device busy time and
   the kernels that take it;
5. drive a ``GraspService`` (``union_half``, standard CNN) on the card
   through ``on_mask`` / ``on_depth`` / ``process_pending``: once with
   ``pipeline_depth=0`` and a recorder, once with depth 2 plus
   ``flush()``, once replaying the recorded log; the three runs must
   publish the same messages in the same order, and the first frame of
   each family the message of a ``device="cpu"`` service (pixel equal,
   floats within 1e-6). A fourth service built with ``hist_median=True``
   takes the first frames of each family and must publish the default's
   messages (pixel equal, floats within 1e-6). The launch counts are set
   to 0 before and read after, and must be non-zero for every kernel
   of the frame path;
6. build ``LlavaTorch`` at the LLaVA-1.6-Mistral-7B widths (32 layers,
   bf16, random weights from seed 0, the five anyres pinpoints, flash
   prefill) and score five candidates on a 1080 x 1440 frame directly
   (t = 2400 tokens, 64 flash launches: the shared image prefix's and
   the rows' text's attention, 32 each), again through the chunked
   route (first-step logits and tokens compared) and one by one, then
   serve frames through
   ``GraspService(hybrid_selector=HybridGraspSelector(VLAProcessor(
   scorer)))``: every measured frame must carry a VLA choice, publish a
   message and launch the flash kernel 64 times; then the two
   degradations on purpose (a backend that raises, a selector that
   raises), and ``TinyVLAScorer`` on the card once;
7. training: (a) the attention gate's gradient kernel against its plain
   version at the four architectures' training shapes (batch 16), at N
   of 1, 17 and 33 and at the kernel's limits (HW 64, C 1024, R 64) in
   the three gated modes, x as the CNN passes it and contiguous, dy
   contiguous, channel-major and with stride 0 along HW (the average
   pool's gradient): dx within 1e-5 absolute, each parameter gradient
   within 1e-5 of its norm, two runs bit-equal; mode ``none`` passes dy
   through; one call runs one kernel on the card (a profile), timed as
   the median of five profiles beside an empty launch and K2's forward; (b) the teacher (``collect_from_frames``) on six 1080 x 1440
   frames of the bench families in ``reference_self`` with the collector
   on the card, the teacher's kernels (min-plus, fused scoring) counted,
   the first frame's teacher point, score (1e-5) and negative pools
   against the CPU path; (c) one train step of the standard CNN (dropout
   0, the same weights) on the card against the CPU: every parameter a
   finite gradient within 3e-5 of its norm of the CPU's, the gate and
   its gradient launched once; then ``Trainer(device=None).fit`` of the
   standard CNN from ``init_like_flax_`` (seed 42) on the stored
   1230-sample corpus for 10 epochs, with the counts set to 0 just
   before (the gate's backward must launch once a step, its forward once
   a step and once a validation batch) and the best validation loss
   below the first epoch's; a checkpoint saved and reloaded through
   ``GraspQualityPredictor`` (same logits, same norm stats); one step
   profiled;
8. VLA training: (a) the flash prefill's backward kernels
   (``flash_prefill_bwd_dq``, ``flash_prefill_bwd_dkv``) against the
   plain backward on the forward kernel's output and log-sum-exp, at the
   training shape (2, 642, 32 over 8, 128) in f32 and bf16, at t = 128,
   200 and 257, head size 64, one to four query heads a K/V head, pads
   inside and across a tile and a pad-only row, q and k at 8 times unit
   scale, K/V as views of a longer cache holding NaN, and the serving
   shape (5, 2400, 32 over 8, 128) in bf16: each gradient within 1e-5 of
   its norm, pad rows and rows beyond t exactly zero, two runs
   bit-equal (the kernels' registers and spills are in the build's log,
   which phase 1 prints); their times beside the bound (the formulas'
   products at the tensor cores' bf16 rate, and beside it the bf16
   products the split issues at that rate), the plain version and
   ``scaled_dot_product_attention``'s backward; the f32 forward (K7-f32)
   at every f32 case and at the training shape and head size 64 with
   q, k x 8, with and without the log-sum-exp: its output within 2e-5 of
   the plain version's (at q, k x 8 plus what four f32 ulps of the row's
   score terms move it by), bit-equal twice, timed at the training shape
   with and without the log-sum-exp beside its bounds (bytes; the
   split's 11 bf16 products), the plain version and SDPA's f32 forward
   (the ``f32`` record inside ``flash_prefill``'s);
   (b) ``LlavaLoRATrainer`` on ``LlavaTorch`` at the
   LLaVA-1.6-Mistral-7B widths (single tile, 576 image tokens; bf16 base
   from seed 0, rank-8 f32 adapters, lr 5e-5, batch 2, ``max_len`` 768,
   the JAX test's byte tokenizer: t = 642) on 20 synthetic examples:
   the first step's adapter gradients on the flash route against the
   chunked route (``lora_a``'s exactly 0 on both), one epoch of 10
   steps with the counts set to 0 just before (32 launches of the
   forward and of each backward kernel a step), the frozen base
   bit-equal after it and every adapter finite, the adapter saved and
   reloaded (equal logits), one step profiled, five steps on one batch
   (after the first, the loss falls at every step and ends below the
   first); (c) one step with the adapters in bf16 (the bf16
   forward with its log-sum-exp and the bf16 backward);
9. serving from a checkpoint on disk: (a) a 3-shard HF-layout checkpoint
   at the LLaVA-1.6-Mistral-7B tensor shapes cut to 2 decoder and 2
   vision layers (about 1.5 GB bf16, seeded random weights, the port's
   own ``write_synthetic_llava_checkpoint``) under
   ``build/chip_smoke_ckpt/``, loaded onto the card in bf16, int8 and
   int4 (group 128): the bf16 state bit-equal to what was written, the
   int8 and int4 codes and scales bit-equal to the host quantizer on the
   same tensors; then one rerank a mode through
   ``tools/serve_llava_torch.py``'s ``main`` (anyres, 1080 x 1440 frame),
   the flash prefill launched once a layer (twice on the shared route:
   the prefix and the text) and the scorer's own record
   showing the rerank finished (its scores, and every candidate's tokens
   decoded); (b) the 7.567 G-parameter model of phase 6 quantized to
   int8 on the card by ``quantize_llava_state_device`` (peak at most the
   bf16 model and one kernel's f32 working set), five candidates scored
   (t 2400, 64 flash launches), profiled, and scored one by one;
   ``QuantDense`` at 5 and 12,000 rows: int8 and int4's per-group
   partials within one bf16 rounding of the f64 product (and int8's
   product rounded to bf16 before its scale shown to miss that limit),
   int4's dequantized product against its plain version, with the
   weight conversions eager torch materializes timed.
10. the parallel layer (leafgrasp_tpu_torch/parallel/) on spawned ranks
   (a file store under ``build/``, a group timeout and a join limit;
   one rank over ``nccl``, two and four ranks sharing ``cuda:0`` over
   ``gloo``, which nccl refuses): (a) ``make_sharded_frame_fn`` on the
   three bench families in ``union`` and ``reference_self`` with the
   CNN at 1080 x 1440, each frame against phase 3's ``make_frame_fn``
   result (leaf, pixel, ``ml_used``, candidate pixels equal; 3D points
   1e-6; fused scores 1e-4 relative), its wall time at 1, 2 and 4 ranks
   (ranks sharing one card: not a multi-device speed) and the
   collectives and bytes of a frame; (b) ``make_batched_frame_fn`` on 4
   frames at 1 and 2 ranks, each frame against ``make_frame_fn``; (c)
   on (2, 1) and (2, 2) meshes one train step of the standard CNN on a
   corpus batch against the single-process step on the card (loss,
   every gradient and the BatchNorm statistics within 3e-5, phase 7c's
   bound), then
   ``Trainer(mesh=...)`` on a 256-sample cut of the corpus for 2 epochs
   (every rank the same, its losses beside the single-process fit's:
   the fits part by more than rounding, see PAR_STEP_REL_TOL); (d)
   ``GraspService(spatial_mesh=...)`` at 2 ranks on 8 frames, rank 0
   publishing the unsharded service's messages. Each rank counts its
   launches; their sum is the ``launches_parallel`` term.
11. the pipeline- and tensor-parallel LLaVA (leafgrasp_tpu_torch/parallel/
   pipeline.py and ``tensor_parallel_``) on ranks sharing ``cuda:0`` as
   in phase 10: (a) ``make_pp_llava_forward`` over 4 stages of the
   7B-width model (32 layers, bf16, seed 0, flash prefill; each rank
   draws only its stage and the replicated rest), 5 microbatches of one
   row of t = 2400 (packed anyres features), last-position logits, and
   again with 1 stage on 1 rank over nccl, each row against
   ``LlavaTorch.forward`` of that row alone (equal, or within phase
   6.2's bound), every rank's peak memory below the whole model's and
   the flash prefill launched 8 x 8 times a rank; (b) 2 stages x 2-way
   tensor parallelism on the same rows (phase 6.2's bound); (c)
   tensor-parallel generate from phase 9a's checkpoint on 2 ranks in
   bf16, int8 and int4 (first-step logits within phase 6.2's bound of
   the single-process model's, tokens' agreement printed, the flash
   prefill once a layer a prefill); (d) the pipelined LoRA step at the
   7B widths cut to 4 layers (one a stage, remat, t = 642): each
   adapter gradient within 1e-3 of its norm of the single-process
   step's, the flash prefill and both its backward kernels launched;
   (e) the tensor-parallel TinyVLA LoRA step on 2 ranks against the
   single-process step. Each rank counts its launches; their sum is the
   ``launches_pipeline`` term.
12. the evaluation, parity and training tools (``tools/*_torch.py``)
   through their ``main``s, launches counted over the phase (the
   ``launches_tools`` term; K1, K3 and K2 must launch, and K2's
   backward in the training CLIs): (a) parity, the 26 golden scenes
   (270 x 360) and the 16 production ones (1080 x 1440), every row's
   leaf, pixel, flag and message equal to PARITY.json /
   PARITY_production.json and the oracle's pixel where it matched
   there; (b) the fuzzer's 100 draws at 540 x 720, its found and
   degenerate counts equal to artifacts/fuzz_parity.json's and its
   first 5 cases equal to the port's CPU path; (c) the system accuracy
   with the converted CNNs (artifacts/torch/): the standard CNN on the
   record's 18 scenes, the hard corpus's ``deep`` CNN with
   ``train_stats`` on the first 10 of 30 hard scenes, each row's
   leaves, pixels and teacher point equal to the committed record; (d)
   the VLA evaluation through two services, 26 hard scenes: every row
   and column equal to the port's CPU record, the geometric columns
   equal to the JAX tool's (the grafted reference and the committed
   record), the VLA columns to the grafted reference wherever the
   scorer's prompts print what JAX's printed; (e) each training CLI
   once at the cut TOOLS_TRAIN_CUTS.
13. the measurement tools (``bench_torch.py``, ``tools/bench_*_torch.py``)
   through their ``main``s, each cut in depth only (BENCH_RUNS), launches
   counted over the phase (the ``launches_bench`` term; K1, K3, K2 and
   K7 must launch, and K7 in each anyres run): (a) ``bench_torch.py`` at
   BENCH_PER_FAMILY frames a family, each family's first frame in both
   configurations equal to the port's CPU path (leaf, pixel, flags); (b)
   the threaded ingest tool on the native frame bus, each published
   message equal to a synchronous service's for that mask and depth;
   the VLA latency tools (single tile, anyres with the flash A/B and the
   stage split, int8 and int4 against bf16); (c) the VLA service at the
   7B widths in int8 with anyres, both degradation checks met; (d) the
   rerank stability in bf16 and int8.
14. the frame's A/B and stage tools (``tools/micro_bench_*_torch.py``)
   through their ``main``s at 1080 x 1440, cut in depth only
   (MICRO_RUNS), launches counted over the phase (the ``launches_micro``
   term; K1, K3/K4, K2, K5 and K6 must launch), each tool's own check
   held: the envelope and interference knobs' pixels equal (frame_ab),
   the banded (K3/K4) and row-banded (K5) EDT routes bit-equal (edt_ab),
   the batched frames on a one-rank nccl mesh equal to the single
   frames (batch), the envelope maxima equal at three stride/k settings
   (stages); and the stage tool's four full frames against the port's
   CPU path (leaf, pixel, flag).

15. the deepseek_v3 decoder's kernels at Moonlight-16B-A3B's widths:
   (a) the flash prefill at latent attention's split heads (q and k 192,
   v 128) against its plain version at the MoE rerank's shape (5, 2400,
   16 heads) with unequal pads and a longer cache holding NaN past t,
   and at a ragged (2, 257) shape, within the bf16 tolerance of phase 2;
   (b) the grouped expert kernel against its plain version (a loop over
   the experts) at a prompt pass's 12000 tokens and a decode step's 5, 6
   of 64 experts a token, an expert left without a pair, within 2^-6 of
   the value plus 2^-6 of the row's largest; their kernel, bound and
   plain milliseconds; (c) the rerank through ``LlavaTorchScorer(anyres
   =True)`` over the whole decoder (27 layers, 16.27 G parameters drawn
   in bf16), launches counted from a reset just before a rerank whose
   decode replays its captured graph (the ``launches_moe_serve`` term:
   two flash prefills a layer of the shared route's prompt pass, the
   prefix's and the rows' text's, and one expert call a layer, none
   from the replayed steps); (d) the
   flash prefill's calls on the shared route in both bf16
   instantiations, the image prefix (one row of 2340 at offset 0) and
   the rows' text (five rows of 60 queries at offset 2340), against
   their plain versions and timed beside the single pass over five rows
   of 2400. ``python3 chip_smoke.py --phase 15`` runs phases 1 and 15
   alone.

TF32 is off for convolutions and matmuls in every phase, so the card
computes the CNN in full f32 as the CPU path does. Before the last line
it prints the card's name and power limit and one JSON line of
per-kernel numbers; the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when there is no CUDA device or the
package is missing.
"""

from __future__ import annotations

import copy
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

H, W = 1080, 1440
# frames the card takes since the min-plus has a direct form: 1080p
# landscape (expanded form) and a frame exact only in the direct form
WIDE_H, WIDE_W = 1080, 1920
TALL_H, TALL_W = 2100, 1600
# frames whose sentinel (H + W)^2 passes 2^24, which the min-plus's
# direct form takes as the JAX package does: a 5 MP machine-vision sensor
# frame and 4K UHD
MP5_H, MP5_W = 2048, 2448
UHD_H, UHD_W = 2160, 3840
CX, CY, F = np.float32(707.87), np.float32(494.07), np.float32(1750.68)
# (name, num_leaves, seed, margin): the bench families (bench.py:37-41)
FAMILIES = [("sparse", 6, 8, 120), ("crowded", 12, 3, 60),
            ("large_leaf", 3, 5, 260)]
MODES = ("reference_self", "union", "union_half")
# frame-function variants: name -> (isolation mode, hist_median)
HIST_VARIANT = "union_half+hist_median"
VARIANTS = {**{mode: (mode, False) for mode in MODES},
            HIST_VARIANT: ("union_half", True)}
FRAMES_PER_CELL = 2
SERVICE_MODE = "union_half"
SERVICE_FRAMES_PER_FAMILY = 8
SERVICE_HIST_FRAMES_PER_FAMILY = 2
SERVICE_FLOAT_TOL = 1e-6
VLA_WARM_FRAMES = 1
VLA_FRAMES = 6
# flash against chunked on the same weights, prompt pass, last position.
# After the first layer the hidden states may differ by LAYER1 of their
# standard deviation: the routes round the probabilities at different
# places, which moves an output by a bf16 ulp (2^-8 of the value, 0.016
# of the deviation at an element four deviations out; read: 0.023). The
# 32 random layers at unit gain then carry that rounding on and add their
# own: the run prints the share after layers 1, 2, 4, ... (read: 0.023,
# 0.040, 0.046, 0.081, 0.106, 0.125, 0.133 after 32) and the first step's
# logits may differ by LOGIT (read: 0.149, and 0.147 with the kernel
# before its wgmma redesign; the limit leaves 1.7 times that). Random
# weights leave near ties, and a row that parts once stays parted: of the
# 50 greedy tokens at most TOKEN may differ (read: 17, and 20 before).
# A wrong route gives unrelated logits (a share of 4 and more) and parts
# all 50. The run also prints the same share for chunked at another
# chunk size and for the rows scored one by one on the flash route
# (read: 0.0 both, the same operations on other shapes).
VLA_MAX_LAYER1_DELTA = 0.06
VLA_MAX_LOGIT_DELTA = 0.25
VLA_MAX_TOKEN_DIFF = 25
VLA_OTHER_CHUNK = 300
N_TEXT = 60
VLA_PINPOINTS = ((336, 672), (672, 336), (672, 672), (1008, 336),
                 (336, 1008))
# |kernel - plain| <= abs + rel * |plain| + row * (largest |plain| of the
# same output row (b, i, h)). bf16: both round the output (an ulp is up
# to 2^-7 of the value) and round the probabilities at different places,
# so two ulps of the value; an output that cancels to near zero carries
# an ulp of the values it was summed from, which the row's largest
# stands for (read at the three shapes: at most 0.0051 of it over the
# relative part), so two ulps of that too and no absolute part.
FLASH_TOL = {"float32": {"abs": 2e-5, "rel": 0.0, "row": 0.0},
             "bfloat16": {"abs": 0.0, "rel": 2.0 ** -6, "row": 2.0 ** -6}}
PEAK_BF16_OPS_PER_S = 989e12
# not on the frame path
VLA_ONLY_KERNELS = ("flash_prefill", "moe_experts", "decode_attention")
TRAIN_ONLY_KERNELS = ("attention_gate_backward", "flash_prefill_bwd_dq",
                      "flash_prefill_bwd_dkv")        # the trainers' only
NOT_ON_FRAMES = VLA_ONLY_KERNELS + TRAIN_ONLY_KERNELS
# each CUDA kernel function of the port -> the launch count of the
# wrapper that launches it, once for each count
KERNEL_FUNCTIONS = {
    "minplus_pass2_kernel": "minplus_pass2",
    "fused_score_maps_kernel": "fused_score_maps",
    "fused_attention_gate_kernel": "fused_attention_gate",
    "attention_gate_backward_kernel": "attention_gate_backward",
    "rowband_kernel": "squared_edt_rowband",
    "rowband_radius_kernel": "squared_edt_rowband",
    "segment_histogram_kernel": "segment_histogram",
    "flash_prefill_kernel": "flash_prefill",
    "flash_prefill_f32_kernel": "flash_prefill",
    "flash_prefill_bwd_dq_kernel": "flash_prefill_bwd_dq",
    "flash_prefill_bwd_dkv_kernel": "flash_prefill_bwd_dkv",
    "moe_experts_gate_up_kernel": "moe_experts",
    "moe_experts_down_kernel": "moe_experts",
    "decode_attention_scores_kernel": "decode_attention",
    "decode_attention_pv_kernel": "decode_attention"}
DECODE_KERNELS = ("decode_attention_scores_kernel",
                  "decode_attention_pv_kernel")
# the decode attention against its plain version in bf16: 2^-7 of the
# value plus 2^-7 of the row's largest (tests/test_torch_cuda.py says why)
DECODE_TOL = 2.0 ** -7
# Late in this script a profile loses the records of the first kernels
# it runs (NVIDIA H100 80GB HBM3, 700.00 W: 0 of 10 launches and then
# 4 of the next kernel's, 3 of 10, 15 of 20, 0 of 3), never the last, so
# every profile starts with LEAD_IN_LAUNCHES launches of torch's spin
# kernel (LEAD_IN_CYCLES clock cycles each), which no reading counts
LEAD_IN_KERNEL = "spin_kernel"
LEAD_IN_LAUNCHES = 32
LEAD_IN_CYCLES = 1_000_000
# The bf16 flash prefill before its redesign (mma.sync m16n8k16, cp.async,
# 64-row blocks), at the serving shape, as this script's previous
# version timed it in one run on one card with this version (0.441 and
# 0.443 ms; the library call 0.437-0.445 ms): NVIDIA H100 80GB HBM3,
# 700.00 W. That kernel is gone from the sources; the number is logged,
# not part of the kernels line.
FLASH_PREV_MS = 1.214
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
SCORING_TOL = 1e-5
GATE_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_function(key: str):
    """The port's kernel function that a profiler row names, or None
    (template instances and namespaces are part of the row's name)."""
    for fn in KERNEL_FUNCTIONS:
        if re.search(rf"\b{fn}\b", key):
            return fn
    return None


def lead_in(torch) -> None:
    """Open a profiled region: run the spin kernel LEAD_IN_LAUNCHES
    times and wait for the card, so that a profile that loses its first
    records loses these."""
    for _ in range(LEAD_IN_LAUNCHES):
        torch.cuda._sleep(LEAD_IN_CYCLES)
    torch.cuda.synchronize()


def is_lead_in(name: str) -> bool:
    return LEAD_IN_KERNEL in name


def kernel_ms(fn, kernel, iters: int = 20) -> float:
    """Mean device milliseconds of the CUDA kernel named ``kernel`` (or
    of the kernels of a tuple of names, summed) per call of ``fn`` (the
    kernels alone, without their wrapper's other ops), from
    ``torch.profiler``: each kernel's mean over the launches the profile
    recorded, times its launches a call, which its wrapper's launch
    count gives."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from leafgrasp_tpu_torch.kernels import launch_counts
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    before = launch_counts()
    fn()
    torch.cuda.synchronize()
    after = launch_counts()
    per_call = {name: after[KERNEL_FUNCTIONS[name]]
                - before[KERNEL_FUNCTIONS[name]] for name in names}
    if not all(per_call.values()):
        raise RuntimeError(f"a call launched {per_call}")
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_in(torch)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rec = {name: [0.0, 0] for name in (*names, LEAD_IN_KERNEL)}
        for ev in prof.key_averages():
            name = LEAD_IN_KERNEL if is_lead_in(ev.key) \
                else kernel_function(ev.key)
            if name in rec:
                rec[name][0] += ev.self_device_time_total
                rec[name][1] += ev.count
        seen = {name: n for name, (_, n) in rec.items()}
        if any(seen[name] != per_call[name] * iters for name in names) \
                or seen[LEAD_IN_KERNEL] != LEAD_IN_LAUNCHES:
            log(f"kernel_ms: the profiler recorded {seen} launches of "
                f"{LEAD_IN_LAUNCHES} of the lead-in and {iters} calls of "
                f"{per_call}")
        if all(seen[name] for name in names):
            return sum(rec[name][0] / rec[name][1] * per_call[name]
                       for name in names) / 1e3
    raise RuntimeError(f"the profiler recorded no launch of {names}")


def device_kernels(fn) -> list:
    """The names of the kernels, memsets and copies one call of ``fn``
    ran on the card, in order, from a profile (the lead-in left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in sorted(prof.events(),
                                     key=lambda e: e.time_range.start)
            if ev.device_type == DeviceType.CUDA and not is_lead_in(ev.name)]


def launch_floor_ms(torch, dev, iters: int = 20):
    """(median, readings) of the device ms of an empty launch: a fill of
    one f32 element, each profile's kernels over its launches."""
    from torch.profiler import ProfilerActivity, profile
    z = torch.empty((1,), device=dev)
    reps = []
    for _ in range(5):
        z.fill_(0.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_in(torch)
            for _ in range(iters):
                z.fill_(0.0)
            torch.cuda.synchronize()
        got = [(ev.self_device_time_total, ev.count)
               for ev in prof.key_averages()
               if not is_lead_in(ev.key) and ev.self_device_time_total > 0]
        if got:
            reps.append(sum(t for t, _ in got) / sum(n for _, n in got) / 1e3)
    if not reps:
        raise RuntimeError("the profiler recorded no fill kernel")
    return statistics.median(reps), reps


def bound(bytes_moved: float, ops: float, peak_ops=PEAK_F32_OPS_PER_S):
    """(least ms, what bounds it) on the published H100 peaks."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def issue_rate(torch) -> float:
    """Warp-instruction lanes the card issues a second: each SM issues one
    warp instruction (32 lanes) a cycle in each of its four partitions,
    at the card's highest SM clock as ``nvidia-smi`` gives it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=30, check=True)
    hz = float(out.stdout.strip().splitlines()[0]) * 1e6
    return torch.cuda.get_device_properties(0).multi_processor_count \
        * 128 * hz


def minplus_sources(r: int, w: int, nq: int, band=None) -> int:
    """(row, query, source) triples that a min-plus call must visit."""
    if band is None:
        return r * nq * w
    from leafgrasp_tpu_torch.kernels.minplus import BAND_COLS, BAND_ROWS
    nb = band.cpu().numpy().astype(np.int64)
    total = 0
    for rt in range(nb.shape[0]):
        rows = min(BAND_ROWS, r - rt * BAND_ROWS)
        for qt in range(nb.shape[1]):
            cols = min(BAND_COLS, nq - qt * BAND_COLS)
            lo = max(0, (qt - nb[rt, qt]) * BAND_COLS)
            hi = min(w, (qt + nb[rt, qt] + 1) * BAND_COLS)
            total += rows * cols * (hi - lo)
    return total


def pass1_g2(torch, dev, h, w):
    """The pass-1 field of the first leaf's complement on an h x w scene
    of the sparse family, as the frame path's full EDT makes it."""
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    _, n, seed, margin = FAMILIES[0]
    mask, _ = make_leaf_scene(h, w, num_leaves=n, seed=seed, margin=margin)
    return seeds_g2(torch, ~(torch.as_tensor(mask, device=dev) == 1))


def seeds_g2(torch, seeds):
    """The pass-1 squared field of a seed mask."""
    from leafgrasp_tpu_torch.ops.edt import nearest_seed_dist_1d
    g = nearest_seed_dist_1d(seeds, axis=0).to(torch.float32)
    return (g * g).contiguous()


def edge_rows(torch, dev, w, big, top):
    """Rows of the sentinel ``big`` alone, with a source at the first, the
    last or both columns, and rows of the largest admitted value ``top``;
    every column is a query."""
    edge = torch.full((80, w), float(big), device=dev)
    edge[16:32, 0] = 0.0
    edge[32:48, w - 1] = 0.0
    edge[48:64] = float(top)
    edge[64:80, 0] = 0.0
    edge[64:80, w - 1] = 1.0
    return edge


def check_minplus(torch, dev, leaf, other):
    """The min-plus in each form the main path calls, with the bound the
    path states (the frame's sentinel), with a source sub-range as
    ``squared_edt_window_src`` calls it, and at the edge of the expanded
    form's exact range; then the frames the direct form takes: the full
    sweeps of a 2100 x 1600, a 2048 x 2448 (5 MP) and a 2160 x 3840 (4K)
    frame's field, whose sentinels pass 2^24, 80 rows of a seedless
    2048 x 2448 field and a source sub-range that holds no seed (both
    the sentinel everywhere), and rows of the direct form's old edge; and
    a 1080 x 1920 frame's full sweep in the expanded form; all
    bit-exact."""
    from leafgrasp_tpu_torch.kernels.minplus import (
        BAND_COLS, BAND_ROWS, max_g2, minplus_form, minplus_pass2,
        minplus_pass2_plain)
    from leafgrasp_tpu_torch.ops.edt import (_tile_candidates, exact_sqrt,
                                            nearest_seed_dist_1d)
    from leafgrasp_tpu_torch.ops.morphology import dilate, elliptical_kernel

    seeds = torch.stack([~leaf, leaf, dilate(other, elliptical_kernel(40))])
    g = nearest_seed_dist_1d(seeds, axis=1).to(torch.float32)
    g2 = (g * g).contiguous()
    c3 = g2.shape[0]
    js = torch.cat([torch.arange(0, W, 16, dtype=torch.int32, device=dev),
                    torch.tensor([W - 1], dtype=torch.int32, device=dev)])
    ds = exact_sqrt(minplus_pass2_plain(g2[1], qcol=js))
    _, flat, _ = _tile_candidates(ds, 1024)
    rows = flat // js.shape[0]
    jwin = torch.clamp(js[flat % js.shape[0]].to(torch.int64)[:, None]
                       + torch.arange(-8, 9, device=dev)[None, :], 0, W - 1)
    refine_g2 = g2[1][rows].contiguous()
    hq = wq = 320
    win_g2 = g2[:, 200:200 + hq, :].reshape(c3 * hq, W).contiguous()
    band = torch.full((-(-H // BAND_ROWS), -(-W // BAND_COLS)), 2,
                      dtype=torch.int32, device=dev)
    big = (H + W) ** 2
    tall_big = (TALL_H + TALL_W) ** 2
    wide_big = (WIDE_H + WIDE_W) ** 2
    mp5_big = (MP5_H + MP5_W) ** 2
    uhd_big = (UHD_H + UHD_W) ** 2
    # a 5 MP frame without a seed, and one whose only seeds (a 40 x 40
    # blob) lie far left of the sub-range's source columns (its last 600)
    no_seed = torch.zeros((MP5_H, MP5_W), dtype=torch.bool, device=dev)
    blob = no_seed.clone()
    blob[500:540, 100:140] = True
    mid = slice(MP5_H // 2 - 40, MP5_H // 2 + 40)
    # name -> (g2, keywords, the bound the caller states, the value every
    # output must hold or None)
    forms = {
        "full": (g2[1], {}, big, None),
        "window": (win_g2, {"qcol": torch.arange(
            400, 400 + wq, dtype=torch.int32, device=dev)}, big, None),
        "sampled": (g2.reshape(c3 * H, W), {"qcol": js}, big, None),
        "refine": (refine_g2, {"qcol": jwin.to(torch.int32).contiguous()},
                   big, None),
        "banded": (g2[0].contiguous(), {"band": band}, big, None),
        "subrange": (win_g2, {"qcol": torch.arange(
            401, 401 + wq, dtype=torch.int32, device=dev),
            "s_lo": 273, "s_hi": 849}, big, None),
        "edge": (edge_rows(torch, dev, W, big, max_g2(W)), {}, max_g2(W),
                 None),
        "direct_2100x1600": (pass1_g2(torch, dev, TALL_H, TALL_W), {},
                             tall_big, None),
        "direct_2048x2448": (pass1_g2(torch, dev, MP5_H, MP5_W), {},
                             mp5_big, None),
        "direct_2160x3840": (pass1_g2(torch, dev, UHD_H, UHD_W), {},
                             uhd_big, None),
        "direct_seedless_2048x2448": (seeds_g2(torch, no_seed)[mid], {},
                                      mp5_big, mp5_big),
        "direct_subrange_no_seed_2048x2448": (
            seeds_g2(torch, blob)[mid].contiguous(),
            {"qcol": torch.arange(MP5_W - 500, MP5_W - 100,
                                  dtype=torch.int32, device=dev),
             "s_lo": MP5_W - 600, "s_hi": MP5_W},
            mp5_big, mp5_big),
        "direct_edge": (edge_rows(torch, dev, TALL_W, tall_big,
                                  2 ** 24 - TALL_W ** 2), {},
                        2 ** 24 - TALL_W ** 2, None),
        "expanded_1080x1920": (pass1_g2(torch, dev, WIDE_H, WIDE_W), {},
                               wide_big, None),
    }
    out, floors = {}, {}
    lanes_per_s = issue_rate(torch)
    for name, (x, kw, g2_max, every) in forms.items():
        r, w = x.shape
        form = minplus_form(w, g2_max)
        if name.startswith(("direct", "expanded")) \
                and form != name.split("_")[0]:
            raise RuntimeError(f"minplus {name}: the {form} form was chosen")
        got = minplus_pass2(x, g2_max=g2_max, **kw)
        want = minplus_pass2_plain(x, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise RuntimeError(f"minplus {name}: kernel != plain, max abs "
                               f"diff {err}")
        if every is not None and not bool((got == float(every)).all()):
            raise RuntimeError(f"minplus {name}: not the sentinel {every} "
                               f"everywhere")
        nq = w if "qcol" not in kw else kw["qcol"].shape[-1]
        n_src = kw.get("s_hi", w) - kw.get("s_lo", 0)
        triples = minplus_sources(r, n_src, nq, kw.get("band"))
        b_ms, b_by = bound(4.0 * (r * n_src + r * nq), 2.0 * triples)
        out[name] = {
            "shape": [r, w, nq], "form": form, "g2_max": g2_max,
            "max_abs_err": err,
            "ms": kernel_ms(lambda: minplus_pass2(x, g2_max=g2_max, **kw),
                            "minplus_pass2_kernel"),
            "wrapper_ms": cuda_ms(lambda: minplus_pass2(x, g2_max=g2_max,
                                                        **kw)),
            "plain_ms": cuda_ms(lambda: minplus_pass2_plain(x, **kw),
                                iters=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by}
        log(f"minplus {name} {json.dumps(out[name])}")
        # computed, not measured, so not part of the kernels line: a
        # multiply-add and a min a triple at the card's issue rate (the
        # direct form adds a subtract for eight triples)
        floors[name] = 2.0 * triples / lanes_per_s * 1e3
    log(f"minplus issue-rate floor ms (computed from the highest SM clock) "
        f"{json.dumps(floors)}")
    full = out["full"]
    return {"name": "minplus_pass2", "route": "cuda",
            "source": "leafgrasp_tpu_torch/kernels/csrc/minplus.cu",
            "replaces": "leafgrasp_tpu/ops/pallas_edt.py:65",
            "tolerance": 0.0, "max_abs_err": max(
                f["max_abs_err"] for f in out.values()),
            "ms": full["ms"], "wrapper_ms": full["wrapper_ms"],
            "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "library_ms": None, "forms": out}


def check_scoring(torch, dev, leaf, other, depth):
    """Fused scoring at 1080 x 1440 on the main path's fields."""
    from leafgrasp_tpu_torch.config import GraspScoringConfig
    from leafgrasp_tpu_torch.geometry.grasp_scorer import stem_penalty_map
    from leafgrasp_tpu_torch.kernels.scoring import (
        fused_score_maps, fused_score_maps_plain)
    from leafgrasp_tpu_torch.ops.conv import gradient_magnitude
    from leafgrasp_tpu_torch.ops.edt import edt
    from leafgrasp_tpu_torch.ops.morphology import dilate, elliptical_kernel
    from leafgrasp_tpu_torch.ops.pca import min_area_rect

    cfg = GraspScoringConfig()
    din = edt(~leaf)
    dclose = edt(dilate(other, elliptical_kernel(30)))
    dwide = edt(dilate(other, elliptical_kernel(40)))
    grad = gradient_magnitude(depth * leaf.to(torch.float32))
    o = min_area_rect(leaf)
    cx, cy, f = (torch.tensor(v, device=dev) for v in (CX, CY, F))
    args = (din, torch.zeros_like(din), dclose, dwide, grad,
            leaf.to(torch.float32), stem_penalty_map(leaf, cfg), cx, cy, f,
            o.angle, o.valid)
    kw = {"cfg": cfg, "max_sdf": din.max(), "max_close": dclose.max(),
          "max_wide": dwide.max()}
    got = fused_score_maps(*args, **kw)
    want = fused_score_maps_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got[:8], want[:8]))
    if err > SCORING_TOL or not torch.equal(got[8], want[8]):
        raise RuntimeError(f"fused_score_maps: max abs err {err}, valid "
                           f"equal {torch.equal(got[8], want[8])}")
    # 7 f32 fields in, 8 f32 maps and a byte mask out; ~70 f32 ops a pixel
    b_ms, b_by = bound((7 * 4 + 8 * 4 + 1) * H * W, 70.0 * H * W)
    rec = {"name": "fused_score_maps", "route": "cuda",
           "source": "leafgrasp_tpu_torch/kernels/csrc/scoring.cu",
           "replaces": "leafgrasp_tpu/ops/pallas_scoring.py:130",
           "tolerance": SCORING_TOL, "max_abs_err": err,
           "ms": kernel_ms(lambda: fused_score_maps(*args, **kw),
                           "fused_score_maps_kernel"),
           "wrapper_ms": cuda_ms(lambda: fused_score_maps(*args, **kw)),
           "plain_ms": cuda_ms(lambda: fused_score_maps_plain(*args, **kw)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    log(f"fused_score_maps {json.dumps(rec)}")
    return rec


# (N, HW, C, R) of the gate: the four architectures at the path's 20
# patches (lightweight, standard, deep, wide; R = C / 16), the kernel's
# limits, and a C that is no multiple of 32 with an odd HW
GATE_SHAPES = {"lightweight": (20, 16, 128, 8), "standard": (20, 16, 256, 16),
               "deep": (20, 4, 256, 16), "wide": (20, 16, 512, 32),
               "limits": (3, 64, 1024, 64), "odd": (5, 9, 48, 3)}


def check_attention(torch, dev):
    """The CNN's gate in all four modes at each architecture's shape and
    at the kernel's limits, from the NCHW view the CNN passes (read
    through its strides), from a contiguous input and from other strides;
    timed at the main path's shape in the path's layout and contiguous."""
    from leafgrasp_tpu_torch.kernels.attention import (
        MODES as GATE_MODES, attention_gate_plain, fused_attention_gate)
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale)
                               .astype(np.float32), device=dev)

    errs, times, inputs = {}, {}, {}
    for arch, (n, hw, c, r) in GATE_SHAPES.items():
        base = torch.relu(t(n, c, hw))
        params = (t(c, 1, scale=c ** -0.5), t(1), t(c, r, scale=c ** -0.5),
                  t(r), t(r, c, scale=r ** -0.5), t(c))
        layouts = {"nchw_view": base.transpose(1, 2),
                   "contiguous": base.transpose(1, 2).contiguous(),
                   "strided": torch.relu(t(n, hw, 2 * c))[:, :, ::2]}
        for layout, x in layouts.items():
            for mode in GATE_MODES:
                got = fused_attention_gate(x, *params, mode)
                want = attention_gate_plain(x, *params, mode)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                errs[f"{arch}/{layout}/{mode}"] = err
                if err > GATE_TOL:
                    raise RuntimeError(f"attention {arch} {layout} {mode}: "
                                       f"max abs err {err}")
        inputs[arch] = (layouts, params)
    layouts, params = inputs["standard"]
    x = layouts["nchw_view"]
    for mode in GATE_MODES:
        times[mode] = {
            "ms": None if mode == "none" else kernel_ms(
                lambda: fused_attention_gate(x, *params, mode),
                "fused_attention_gate_kernel"),
            "wrapper_ms": cuda_ms(
                lambda: fused_attention_gate(x, *params, mode)),
            "plain_ms": cuda_ms(
                lambda: attention_gate_plain(x, *params, mode))}
    spatial_ms = {}
    for arch, (lays, prm) in inputs.items():
        for layout in ("nchw_view", "contiguous"):
            spatial_ms[f"{arch}/{layout}"] = kernel_ms(
                lambda: fused_attention_gate(lays[layout], *prm, "spatial"),
                "fused_attention_gate_kernel")
    n, hw, c, _ = GATE_SHAPES["standard"]
    # spatial, the standard model's mode: x read once and written once,
    # a C-long dot, a sigmoid and a multiply per element
    b_ms, b_by = bound(2 * 4 * n * hw * c + 4 * (c + 1), 3.0 * n * hw * c)
    rec = {"name": "fused_attention_gate", "route": "cuda",
           "source": "leafgrasp_tpu_torch/kernels/csrc/attention.cu",
           "replaces": "leafgrasp_tpu/models/attention_pallas.py:63",
           "tolerance": GATE_TOL, "max_abs_err": max(errs.values()),
           "ms": times["spatial"]["ms"],
           "wrapper_ms": times["spatial"]["wrapper_ms"],
           "plain_ms": times["spatial"]["plain_ms"],
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "modes_ms": times, "spatial_ms": spatial_ms}
    log(f"fused_attention_gate {json.dumps(rec)}")
    return rec


def rowband_pairs(nb, h: int, w: int) -> int:
    """(output, candidate row) pairs inside the tiles' row bands."""
    from leafgrasp_tpu_torch.kernels.rowband import TILE_COLS, TILE_ROWS
    nb = nb.cpu().numpy().astype(np.int64)
    rt = np.arange(nb.shape[1])
    row0 = rt * TILE_ROWS
    rows = np.minimum(TILE_ROWS, h - row0)[None, :, None]
    cols = np.minimum(TILE_COLS, w - np.arange(nb.shape[2])
                      * TILE_COLS)[None, None, :]
    lo = np.maximum(row0[None, :, None] - nb, 0)
    hi = np.minimum(row0[None, :, None] + TILE_ROWS - 1 + nb, h - 1)
    return int((rows * cols * (hi - lo + 1)).sum())


def check_rowband(torch, dev, leaf, other):
    """The row-banded EDT at the path's shape (the pooled, dilated
    interference at half resolution), at the half resolution of a
    1080 x 1920 frame, and on three full frames, bit-exact against the
    full sweep, radii included."""
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.kernels.rowband import (
        rowband_radii_plain, squared_edt_rowband, squared_edt_rowband_plain)
    from leafgrasp_tpu_torch.ops.edt import nearest_seed_dist_1d
    from leafgrasp_tpu_torch.ops.morphology import dilate, elliptical_kernel

    def half_interference(other):
        inter = dilate(other, elliptical_kernel(40))
        h, w = inter.shape
        return inter.reshape(h // 2, 2, w // 2, 2).any(dim=3).any(dim=1)[None]

    _, n, seed, margin = FAMILIES[0]
    wide, _ = make_leaf_scene(WIDE_H, WIDE_W, num_leaves=n, seed=seed,
                              margin=margin)
    wide = torch.as_tensor(wide, device=dev)
    forms = {"half": half_interference(other),
             "half_1080x1920": half_interference((wide > 0) & (wide != 1)),
             "full3": torch.stack([~leaf, leaf, other])}
    out = {}
    for name, seeds in forms.items():
        g = nearest_seed_dist_1d(seeds, axis=2).to(torch.float32)
        g2r = (g * g).contiguous()
        c, h, w = g2r.shape
        got, nb = squared_edt_rowband(g2r, return_radii=True)
        want = squared_edt_rowband_plain(g2r)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise RuntimeError(f"rowband {name}: kernel != plain, max abs "
                               f"diff {err}")
        if not torch.equal(nb, rowband_radii_plain(g2r)):
            raise RuntimeError(f"rowband {name}: radii != plain radii")
        pairs = rowband_pairs(nb, h, w)
        b_ms, b_by = bound(8.0 * c * h * w, 2.0 * pairs)
        full_ms, _ = bound(8.0 * c * h * w, 2.0 * c * h * h * w)

        def run():
            return squared_edt_rowband(g2r)

        sweep = kernel_ms(run, "rowband_kernel")
        radius = kernel_ms(run, "rowband_radius_kernel")
        out[name] = {
            "shape": [c, h, w], "max_abs_err": err,
            "pairs_in_band": pairs, "pairs_full_sweep": c * h * h * w,
            "ms": sweep + radius, "sweep_ms": sweep, "radius_ms": radius,
            "wrapper_ms": cuda_ms(run),
            "plain_ms": cuda_ms(lambda: squared_edt_rowband_plain(g2r),
                                iters=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "full_sweep_bound_ms": full_ms}
        log(f"rowband {name} {json.dumps(out[name])}")
    # computed, not measured: a multiply-add and a min a pair at the card's
    # issue rate
    lanes_per_s = issue_rate(torch)
    floors = {k: 2.0 * v["pairs_in_band"] / lanes_per_s * 1e3
              for k, v in out.items()}
    log(f"rowband issue-rate floor ms (computed from the highest SM clock) "
        f"{json.dumps(floors)}")
    half = out["half"]
    return {"name": "squared_edt_rowband", "route": "cuda",
            "source": "leafgrasp_tpu_torch/kernels/csrc/rowband.cu",
            "replaces": "leafgrasp_tpu/ops/pallas_edt.py:215",
            "tolerance": 0.0, "max_abs_err": max(
                f["max_abs_err"] for f in out.values()),
            "ms": half["ms"], "wrapper_ms": half["wrapper_ms"],
            "plain_ms": half["plain_ms"], "bound_ms": half["bound_ms"],
            "bound_by": half["bound_by"], "library_ms": None, "forms": out}


def check_histogram(torch, dev, mask, depth):
    """The segment histogram at 1080 x 1440 with 18 segments: one bracket
    at the first level and at a refined level, and the refined level's
    two brackets in one launch (R = 2, as the median makes it), each
    against its plain version and ``torch.bincount``; a pixel count that
    is no multiple of the vector width, an offset view (the unaligned
    head), depth and ids at different offsets, and ids out of range;
    counts equal. Timed at one and two brackets, the grid swept; then the
    median built on it against the sorted median."""
    from leafgrasp_tpu_torch.kernels import histogram as khist
    from leafgrasp_tpu_torch.kernels.histogram import (
        NBINS, segment_histogram, segment_histogram_plain)
    from leafgrasp_tpu_torch.ops.median import _refine, masked_median_hist

    num = 18
    ids = torch.clamp(mask, 0, num - 1).to(torch.int32)
    counts = torch.bincount(ids.reshape(-1).to(torch.int64), minlength=num)
    dmin, dmax = depth.min(), depth.max()
    span = torch.clamp(dmax - dmin, min=1e-12)
    lo1, w1 = dmin.expand(num).contiguous(), span.expand(num).contiguous()
    hist1 = segment_histogram(depth, ids, lo1, NBINS / w1, num)
    ks = torch.stack([torch.clamp(counts - 1, min=0) // 2, counts // 2]) \
        .to(torch.float32)
    lo2, w2 = _refine(hist1, ks, lo1, w1)
    lo2, iw2 = lo2.contiguous(), (NBINS / w2.expand_as(lo2)).contiguous()
    levels = {"level1": (lo1, NBINS / w1), "level2": (lo2[1], iw2[1]),
              "level2_two_brackets": (lo2, iw2)}

    def keys(d, i, lo, inv_w):
        """bincount keys of the same function, R brackets stacked."""
        lo, inv_w = lo.reshape(-1, num), inv_w.reshape(-1, num)
        il = i.reshape(-1).to(torch.int64)
        ok = (il >= 0) & (il < num)
        ic = torch.clamp(il, 0, num - 1)
        b = torch.clamp((d.reshape(-1)[None] - lo[:, ic]) * inv_w[:, ic],
                        0.0, float(NBINS - 1)).to(torch.int64)
        seg = torch.arange(lo.shape[0], device=dev)[:, None] * num + ic
        cells = lo.shape[0] * num * NBINS
        return torch.where(ok[None], seg * NBINS + b,
                           torch.full_like(b, cells)).reshape(-1), cells

    out = {}
    for name, (lo, inv_w) in levels.items():
        rr = lo.shape[0] if lo.dim() == 2 else 1
        got = segment_histogram(depth, ids, lo, inv_w, num)
        want = segment_histogram_plain(depth, ids, lo, inv_w, num)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want) or float(got.sum()) != rr * H * W:
            raise RuntimeError(f"segment_histogram {name}: counts differ, "
                               f"max abs diff {err}")
        key, cells = keys(depth, ids, lo, inv_w)
        if not torch.equal(torch.bincount(key, minlength=cells)[:cells]
                           .reshape(got.shape).to(torch.float32), got):
            raise RuntimeError(f"segment_histogram {name}: bincount differs")
        if rr == 2 and not all(torch.equal(got[r], segment_histogram(
                depth, ids, lo[r], inv_w[r], num)) for r in range(2)):
            raise RuntimeError(f"segment_histogram {name}: a bracket "
                               f"differs from its one-bracket launch")
        # each pixel's depth and id read once, the brackets read once and
        # the counts written once; a subtract, a multiply and a clip a
        # pixel and bracket
        b_ms, b_by = bound(8.0 * H * W + 8.0 * rr * num
                           + 4.0 * rr * num * NBINS, 4.0 * rr * H * W)
        out[name] = {
            "brackets": rr, "max_abs_err": err,
            "ms": kernel_ms(
                lambda: segment_histogram(depth, ids, lo, inv_w, num),
                "segment_histogram_kernel"),
            "wrapper_ms": cuda_ms(
                lambda: segment_histogram(depth, ids, lo, inv_w, num)),
            "plain_ms": cuda_ms(
                lambda: segment_histogram_plain(depth, ids, lo, inv_w, num)),
            # one library call on PRECOMPUTED keys: it leaves out the
            # gather, subtract, multiply, clamp and cast that the kernel
            # does, so it is a lower limit for the library route;
            # plain_ms is the like-for-like figure
            "library_ms": cuda_ms(
                lambda: torch.bincount(key, minlength=cells + 1)),
            "bound_ms": b_ms, "bound_by": b_by}
        log(f"segment_histogram {name} {json.dumps(out[name])}")

    # the edges of a call: no multiple of the vector width, an offset view
    # (the unaligned head), depth and ids at different offsets from a
    # 16-byte boundary (the wrapper copies), ids out of range
    flat_d, flat_i = depth.reshape(-1), ids.reshape(-1)
    wild = (flat_i * 7 % (num + 3)) - 1                    # -1 .. num + 1
    cases = {"ragged": (flat_d[:H * W - 5], flat_i[:H * W - 5]),
             "offset_view": (flat_d[3:], flat_i[3:]),
             "offsets_differ": (flat_d[1:], flat_i[:-1]),
             "ids_out_of_range": (flat_d, wild)}
    for name, (d, i) in cases.items():
        for lo, inv_w in (levels["level1"], levels["level2_two_brackets"]):
            got = segment_histogram(d, i, lo, inv_w, num)
            want = segment_histogram_plain(d, i, lo, inv_w, num)
            torch.cuda.synchronize()
            inside = float(((i >= 0) & (i < num)).sum())
            if not torch.equal(got, want) \
                    or float(got.sum()) != inside * (lo.numel() // num):
                raise RuntimeError(f"segment_histogram {name}: counts "
                                   f"differ")
    log(f"segment_histogram edge cases {list(cases)}: counts equal at one "
        f"and two brackets")

    # the grid: blocks an SM the launcher aims at (the default is
    # khist._BLOCKS_PER_SM; one block of 1024 threads fills an SM's
    # registers, so more run in waves)
    sweep = {}
    default = khist._BLOCKS_PER_SM
    try:
        for per_sm in (1, 2, 4):
            khist._BLOCKS_PER_SM = per_sm
            sweep[per_sm] = {
                name: kernel_ms(lambda: segment_histogram(
                    depth, ids, *levels[name], num),
                    "segment_histogram_kernel")
                for name in ("level1", "level2_two_brackets")}
    finally:
        khist._BLOCKS_PER_SM = default
    log(f"segment_histogram grid sweep, kernel ms by blocks an SM "
        f"(default {default}): {json.dumps(sweep)}")

    med = masked_median_hist(depth, ids, counts, num)
    med_err = 0.0
    tol = float(span) / NBINS ** 2
    for n in range(num):
        if int(counts[n]) == 0:
            continue
        want = torch.sort(depth[ids == n]).values
        k = int(counts[n])
        ref = 0.5 * (float(want[(k - 1) // 2]) + float(want[k // 2]))
        med_err = max(med_err, abs(float(med[n]) - ref))
    if med_err > tol:
        raise RuntimeError(f"masked_median_hist: off by {med_err} > {tol}")
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.ops.components import masked_median
    reset_launch_counts()
    masked_median_hist(depth, ids, counts, num)
    med_launches = launch_counts()["segment_histogram"]
    if med_launches != 2:
        raise RuntimeError(f"masked_median_hist launched the histogram "
                           f"{med_launches} times, not 2")
    med_ms = {
        "hist_ms": cuda_ms(
            lambda: masked_median_hist(depth, ids, counts, num)),
        "bisection_ms": cuda_ms(
            lambda: masked_median(depth, ids, counts, num)),
        "histogram_launches": med_launches,
        "max_abs_err_vs_sorted": med_err, "tolerance": tol}
    log(f"masked_median {json.dumps(med_ms)}")
    first = out["level1"]
    return {"name": "segment_histogram", "route": "cuda",
            "source": "leafgrasp_tpu_torch/kernels/csrc/histogram.cu",
            "replaces": "leafgrasp_tpu/ops/pallas_median.py:76",
            "tolerance": 0.0, "max_abs_err": max(
                f["max_abs_err"] for f in out.values()),
            "ms": first["ms"], "wrapper_ms": first["wrapper_ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "levels": out,
            "grid_sweep_ms": sweep, "median": med_ms}


def flash_diff(got, want, tol):
    """(largest |got - want|, largest share of its output row's largest
    |want| by which a difference exceeds the relative part, largest
    amount by which one exceeds the whole tolerance: <= 0 passes)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rowmax = want.abs().amax(-1, keepdim=True)
    excess = diff - tol["rel"] * want.abs()
    share = (excess / rowmax.clamp_min(1e-30)).max().item()
    over = (excess - tol["row"] * rowmax).max().item() - tol["abs"]
    return diff.max().item(), share, over


def check_flash(torch, dev):
    """The flash-attention prefill against its plain version: f32 and
    bf16, unequal left pads including 0 and pads that end inside a 64-row
    group, prompts shorter than a tile and no multiple of one, one and
    four query heads a K/V head, K/V read through the strides of a
    longer cache whose rows beyond t hold NaN (a row read from there
    would show in the result); then its time at the serving shape with
    the serving path's pads (all 0: the prompts have one length)."""
    import torch.nn.functional as F
    from leafgrasp_tpu_torch.kernels.flash_prefill import (
        flash_prefill, flash_prefill_plain)
    shapes = {"small": ((2, 200, 4, 2, 64), (0, 37)),
              "tiny": ((2, 100, 4, 4, 128), (0, 99)),
              "one": ((1, 1, 4, 1, 128), (0,)),
              "group": ((2, 257, 8, 2, 128), (130, 70)),
              "mid": ((5, 640, 32, 8, 128), (0, 3, 64, 130, 639)),
              "ragged": ((2, 2437, 8, 2, 128), (0, 1300)),
              "path": ((5, 2400, 32, 8, 128), (0, 1, 64, 700, 2399))}
    rng = np.random.default_rng(21)
    errs, shares = {}, {}
    for name, ((b, t, heads, kvh, hd), pads) in shapes.items():
        q32 = torch.as_tensor(rng.standard_normal(
            (b, t, heads, hd)).astype(np.float32), device=dev)
        k32, v32 = (torch.as_tensor(rng.standard_normal(
            (b, t + 10, kvh, hd)).astype(np.float32), device=dev)
            for _ in range(2))
        k32[:, t:] = float("nan")             # beyond t: never to be read
        v32[:, t:] = float("nan")
        pad = torch.tensor(pads, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            got = flash_prefill(q, k, v, pad)
            torch.cuda.synchronize()
            want = flash_prefill_plain(q, k, v, pad, chunk=256)
            key = f"{name}/{str(dtype).split('.')[1]}"
            errs[key], shares[key], over = flash_diff(
                got, want, FLASH_TOL[key.split("/")[1]])
            pad_zero = all(not got[i, :p].any() for i, p in enumerate(pads))
            finite = bool(torch.isfinite(got.float()).all())
            log(f"flash_prefill {name} {(b, t, heads, kvh, hd)} pads {pads} "
                f"{dtype}: max abs err on real rows {errs[key]}; over the "
                f"relative part by at most {shares[key]} of the row's "
                f"largest; over the tolerance "
                f"{FLASH_TOL[key.split('/')[1]]} by {over} (must be <= 0), "
                f"pad rows zero {pad_zero}, finite {finite}")
            if not (over <= 0.0 and pad_zero and finite):
                raise RuntimeError(f"flash_prefill {name} {dtype}: err "
                                   f"{errs[key]}, over the tolerance by "
                                   f"{over}, pad rows zero {pad_zero}, "
                                   f"finite {finite}")
            del got, want
    (b, t, heads, kvh, hd), _ = shapes["path"]
    rep = heads // kvh
    pad0 = torch.zeros((b,), dtype=torch.int32, device=dev)
    q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
    real = [t - int(p) for p in pad0.tolist()]
    ops = sum(4.0 * heads * hd * n * (n + 1) / 2 for n in real)
    moved = 2.0 * (2 * b * t * heads * hd + 2 * b * t * kvh * hd) + 4.0 * b
    b_ms, b_by = bound(moved, ops, PEAK_BF16_OPS_PER_S)
    # the library yardstick: one call on the same causal problem, with
    # K/V repeated to the query heads BEFORE the timed call (the kernel
    # reads them grouped, in place)
    ql = q.transpose(1, 2)
    kl = k[:, :t].repeat_interleave(rep, dim=2).transpose(1, 2)
    vl = v[:, :t].repeat_interleave(rep, dim=2).transpose(1, 2)
    lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    got = flash_prefill(q, k, v, pad0)
    lib_err, lib_share, lib_over = flash_diff(got, lib.transpose(1, 2),
                                              FLASH_TOL["bfloat16"])
    if not lib_over <= 0.0:
        raise RuntimeError(f"flash_prefill against the library call: err "
                           f"{lib_err}, over the tolerance by {lib_over}")
    rec = {"name": "flash_prefill", "route": "cuda",
           "source": "leafgrasp_tpu_torch/kernels/csrc/flash_prefill.cu",
           "replaces": "leafgrasp_tpu/vla/llava_jax.py:284",
           "tolerance": FLASH_TOL["bfloat16"]["abs"],
           "tolerance_rel": FLASH_TOL["bfloat16"]["rel"],
           "tolerance_row": FLASH_TOL["bfloat16"]["row"],
           "max_row_share": max(v_ for k_, v_ in shares.items()
                                if k_.endswith("bfloat16")),
           "max_abs_err": max(v_ for k_, v_ in errs.items()
                              if k_.endswith("bfloat16")),
           "max_abs_err_f32": max(v_ for k_, v_ in errs.items()
                                  if k_.endswith("float32")),
           "tolerance_f32": FLASH_TOL["float32"]["abs"],
           "shape": [b, t, heads, kvh, hd],
           "ms": kernel_ms(lambda: flash_prefill(q, k, v, pad0),
                           "flash_prefill_kernel", iters=10),
           "wrapper_ms": cuda_ms(lambda: flash_prefill(q, k, v, pad0),
                                 iters=10),
           "f32_ms": cuda_ms(lambda: flash_prefill(q32, k32, v32, pad0),
                             iters=2, warmup=1),
           "plain_ms": cuda_ms(
               lambda: flash_prefill_plain(q, k, v, pad0, chunk=480),
               iters=2, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               ql, kl, vl, is_causal=True), iters=10),
           "max_abs_diff_vs_library": lib_err,
           "max_row_share_vs_library": lib_share, "operations": ops,
           "bytes": moved}
    rec["tflops"] = ops / rec["ms"] / 1e9
    log(f"flash_prefill before its redesign, a constant of the source and "
        f"not measured in this run: {FLASH_PREV_MS} ms")
    log(f"flash_prefill {json.dumps(rec)}")
    return rec


def check_kernels(torch, dev, mask_np, depth_np):
    """Phase 2: each kernel against its plain version."""
    mask = torch.as_tensor(mask_np.astype(np.int32), device=dev)
    depth = torch.as_tensor(depth_np, device=dev)
    leaf = mask == 1
    other = (mask > 0) & ~leaf
    return [check_minplus(torch, dev, leaf, other),
            check_scoring(torch, dev, leaf, other, depth),
            check_attention(torch, dev),
            check_rowband(torch, dev, leaf, other),
            check_histogram(torch, dev, mask, depth),
            check_flash(torch, dev)]


def run_frames(torch, dev, fns, model, scenes):
    """Phase 3a: the main path on the card, counted and timed."""
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.utils.device import (host_reads,
                                                  reset_host_reads)
    results, frame_ms = {}, {}
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_host_reads()
    for mode in VARIANTS:
        for name, *_ in FAMILIES:
            mask, depth = scenes[name]
            times = []
            for i in range(FRAMES_PER_CELL):
                m_i = np.roll(mask, 3 * i, axis=1)
                d_i = np.roll(depth, 3 * i, axis=1)
                t0 = time.perf_counter()
                res = fns[mode](m_i, d_i, CX, CY, F, model)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    results[(mode, name)] = res
            frame_ms[f"{mode}/{name}"] = {
                "median_ms": statistics.median(times), "ms": times}
    reads = host_reads()
    counts = launch_counts()
    return results, counts, reads, frame_ms


def cross_check(results, cfgs, model_cpu, scenes):
    """Phase 3b: the first frame of each cell against the CPU path built
    the same way, and the ``hist_median`` cells against the default's."""
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    for (mode, name), res in results.items():
        uv = res.grasp_uv.cpu().numpy()
        xyz = res.grasp_xyz.cpu().numpy()
        if uv.shape != (2,) or not np.isfinite(xyz).all() \
                or not bool(res.found):
            raise RuntimeError(f"{mode}/{name}: bad frame result {uv} {xyz}")
        iso, hist = VARIANTS[mode]
        ref = make_frame_fn(cfgs[iso], with_cnn=True, device="cpu",
                            hist_median=hist)(
            *scenes[name], CX, CY, F, model_cpu)
        got = (int(res.leaf_id), uv.tolist(), bool(res.degenerate))
        want = (int(ref.leaf_id), ref.grasp_uv.numpy().tolist(),
                bool(ref.degenerate))
        log(f"frame {mode}/{name}: card (leaf, uv, degenerate) {got} "
            f"cpu {want}")
        if got != want:
            raise RuntimeError(f"{mode}/{name}: card {got} != cpu {want}")
    for name, *_ in FAMILIES:
        a = results[(VARIANTS[HIST_VARIANT][0], name)]
        b = results[(HIST_VARIANT, name)]
        got = (int(b.leaf_id), b.leaf_selection.is_tall.tolist(),
               b.grasp_uv.tolist())
        want = (int(a.leaf_id), a.leaf_selection.is_tall.tolist(),
                a.grasp_uv.tolist())
        log(f"leaf choice {name}: hist_median leaf {got[0]}, default "
            f"{want[0]}")
        if got != want:
            raise RuntimeError(f"{name}: hist_median {got} != default {want}")


def run_wide_frames(torch, cfgs, model, model_cpu):
    """Phase 3c: a 1080 x 1920 frame (the sparse family's scene at that
    width) in each isolation mode on the card, against the CPU path built
    the same way: same leaf, pixel and flag."""
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    _, n, seed, margin = FAMILIES[0]
    scene = make_leaf_scene(WIDE_H, WIDE_W, num_leaves=n, seed=seed,
                            margin=margin)
    cx = np.float32(CX * WIDE_W / W)
    reset_launch_counts()
    for mode in MODES:
        t0 = time.perf_counter()
        res = make_frame_fn(cfgs[mode], with_cnn=True)(*scene, cx, CY, F,
                                                       model)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref = make_frame_fn(cfgs[mode], with_cnn=True, device="cpu")(
            *scene, cx, CY, F, model_cpu)
        got = (int(res.leaf_id), res.grasp_uv.cpu().numpy().tolist(),
               bool(res.degenerate))
        want = (int(ref.leaf_id), ref.grasp_uv.numpy().tolist(),
                bool(ref.degenerate))
        log(f"frame {WIDE_H}x{WIDE_W} {mode}: card (leaf, uv, degenerate) "
            f"{got} cpu {want}, card {ms:.1f} ms (first call)")
        if got != want or not bool(res.found):
            raise RuntimeError(f"{WIDE_H}x{WIDE_W} {mode}: card {got} != "
                               f"cpu {want}")
    counts = launch_counts()
    log(f"phase 3c: {WIDE_H}x{WIDE_W} launches {json.dumps(counts)}")
    if counts["minplus_pass2"] == 0 or counts["squared_edt_rowband"] == 0:
        raise RuntimeError(f"{WIDE_H}x{WIDE_W}: the EDT kernels never ran")


def run_5mp_frame(torch, cfgs, model, model_cpu):
    """Phase 3d: one 2048 x 2448 frame (a 5 MP machine-vision sensor; the
    sparse family's scene at that size) in the default ``union`` mode on
    the card, against the CPU path built the same way: same leaf, pixel
    and flag. Its sentinel (H + W)^2 passes 2^24, so every min-plus of
    its EDTs runs in the direct form."""
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    _, n, seed, margin = FAMILIES[0]
    scene = make_leaf_scene(MP5_H, MP5_W, num_leaves=n, seed=seed,
                            margin=margin)
    cx, cy = np.float32(CX * MP5_W / W), np.float32(CY * MP5_H / H)
    fn = make_frame_fn(cfgs["union"], with_cnn=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    card_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = fn(*scene, cx, cy, F, model)
        torch.cuda.synchronize()
        card_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    t0 = time.perf_counter()
    ref = make_frame_fn(cfgs["union"], with_cnn=True, device="cpu")(
        *scene, cx, cy, F, model_cpu)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    got = (int(res.leaf_id), res.grasp_uv.cpu().numpy().tolist(),
           bool(res.degenerate))
    want = (int(ref.leaf_id), ref.grasp_uv.numpy().tolist(),
            bool(ref.degenerate))
    log(f"frame {MP5_H}x{MP5_W} union: card (leaf, uv, degenerate) {got} "
        f"cpu {want}; card ms {card_ms} (first call, second), cpu path "
        f"{cpu_ms:.1f} ms; launches {json.dumps(counts)}")
    if got != want or not bool(res.found):
        raise RuntimeError(f"{MP5_H}x{MP5_W} union: card {got} != cpu "
                           f"{want}")
    if counts["minplus_pass2"] == 0:
        raise RuntimeError(f"{MP5_H}x{MP5_W}: the min-plus never ran")


def profile_frames(torch, fns, model, scenes):
    """Phase 4: device busy time of one frame per mode, by kernel."""
    from torch.profiler import ProfilerActivity, profile
    mask, depth = scenes["sparse"]
    out = {}
    for mode in VARIANTS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_in(torch)
            t0 = time.perf_counter()
            fns[mode](mask, depth, CX, CY, F, model)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = []
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA \
                    and not is_lead_in(ev.key):
                kernels.append((ev.self_device_time_total / 1e3, ev.count,
                                ev.key))
        kernels.sort(reverse=True)
        busy = sum(k[0] for k in kernels)
        ours = {}
        for ms, n, name in kernels:
            fn = kernel_function(name)
            if fn is not None:                # template instances add up
                rec = ours.setdefault(fn, {"ms": 0.0, "count": 0})
                rec["ms"] += ms
                rec["count"] += n
        out[mode] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "kernel_launches": sum(k[1] for k in kernels),
            "ported_kernels": ours,
            "top": [{"ms": ms, "count": n, "name": name[:80]}
                    for ms, n, name in kernels[:10]]}
        log(f"profile {mode}/sparse {json.dumps(out[mode])}")
    return out


def _same_message(a: str, b: str, tol: float) -> bool:
    """Pixel fields equal, float fields within ``tol``."""
    pa, pb = a.split(","), b.split(",")
    return len(pa) == len(pb) and pa[:2] == pb[:2] and all(
        abs(float(x) - float(y)) <= tol for x, y in zip(pa[2:], pb[2:]))


def run_service(torch, dev, cfg, model, model_cpu, scenes):
    """Phase 5: the grasp service on the card."""
    from leafgrasp_tpu_torch.io.framelog import FrameLogReader
    from leafgrasp_tpu_torch.io.scenes import default_projection
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    from leafgrasp_tpu_torch.pipeline.visualizer import LeafVisualizer
    from leafgrasp_tpu_torch.utils.device import (host_reads,
                                                  reset_host_reads)

    frames = []
    for name, *_ in FAMILIES:
        mask, depth = scenes[name]
        for i in range(SERVICE_FRAMES_PER_FAMILY):
            frames.append((name, i, np.roll(mask, 3 * i, axis=1),
                           np.roll(depth, 3 * i, axis=1)))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, "service.lflg")
    if os.path.exists(log_path):
        os.remove(log_path)

    def make(msgs, device=None, cnn=model, **kw):
        svc = GraspService(cfg, cnn=cnn, publish=msgs.append,
                           min_interval_s=0.0, device=device, **kw)
        svc.set_camera_params(default_projection())
        return svc

    def push(svc, stream):
        outs = []
        for stamp, (mask, depth) in enumerate(stream):
            svc.on_mask(mask, stamp_us=stamp)
            svc.on_depth(depth, stamp_us=stamp)
            outs.append(svc.process_pending(force=True))
        return outs

    stream = [(m, d) for _, _, m, d in frames]
    make([]).process_frame(*stream[0])            # warm-up, uncounted
    make([], hist_median=True).process_frame(*stream[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_host_reads()

    sync_msgs, piped_msgs, replay_msgs = [], [], []
    svc = make(sync_msgs, record_path=log_path)
    t0 = time.perf_counter()
    sync_outs = push(svc, stream)
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    svc.stop()
    reads = host_reads()
    if any(o is None or not o["found"] for o in sync_outs):
        raise RuntimeError("service: a frame was dropped or found no grasp")
    log(f"service frame bus: {'native' if svc.bus.is_native else 'python'}")
    log(f"service pipeline_depth=0: {len(stream)} frames in {sync_s:.3f} s, "
        f"{len(stream) / sync_s} frames/s, host reads per frame "
        f"{reads / len(stream)}")
    log(f"service stages {json.dumps(svc.stats()['stages'])}")
    log(svc.timer.report())

    piped = make(piped_msgs, pipeline_depth=2)
    t0 = time.perf_counter()
    outs = push(piped, stream)
    late = piped.flush()
    torch.cuda.synchronize()
    piped_s = time.perf_counter() - t0
    order = [o["frame_index"] for o in outs if o is not None] \
        + [o["frame_index"] for o in late]
    if outs[0] is not None or outs[1] is not None \
            or order != list(range(len(stream))):
        raise RuntimeError(f"service pipeline_depth=2: order {order}")
    log(f"service pipeline_depth=2: {len(stream)} frames in {piped_s:.3f} "
        f"s, {len(stream) / piped_s} frames/s")

    replay = make(replay_msgs)
    with FrameLogReader(log_path) as rd:
        if len(rd) != len(stream):
            raise RuntimeError(f"service log holds {len(rd)} frames, not "
                               f"{len(stream)}")
        for mask, depth, stamp in rd:
            replay.process_frame(np.array(mask), np.array(depth),
                                 mask_stamp=stamp)
    os.remove(log_path)
    if not (sync_msgs == piped_msgs == replay_msgs) \
            or len(sync_msgs) != len(stream):
        raise RuntimeError(f"service runs disagree: {sync_msgs} / "
                           f"{piped_msgs} / {replay_msgs}")
    log(f"phase 5: three service runs of {len(stream)} frames published "
        f"the same messages")

    hist_msgs = []
    hist_svc = make(hist_msgs, hist_median=True)
    hist_at = [k for k, (_, i, _, _) in enumerate(frames)
               if i < SERVICE_HIST_FRAMES_PER_FAMILY]
    push(hist_svc, [stream[k] for k in hist_at])
    torch.cuda.synchronize()
    counts = launch_counts()
    for msg, k in zip(hist_msgs, hist_at):
        if not _same_message(msg, sync_msgs[k], SERVICE_FLOAT_TOL):
            raise RuntimeError(f"service hist_median frame {k}: {msg} != "
                               f"default {sync_msgs[k]}")
    if len(hist_msgs) != len(hist_at):
        raise RuntimeError("service hist_median: a frame published nothing")
    missing = [k for k, v in counts.items()
               if v == 0 and k not in NOT_ON_FRAMES]
    if missing:
        raise RuntimeError(f"the service launched no {missing}")
    log(f"phase 5: the hist_median service published the default's "
        f"messages on {len(hist_at)} frames; launches {json.dumps(counts)}")

    cpu_msgs = []
    cpu = make(cpu_msgs, device="cpu", cnn=model_cpu)
    for k, (name, i, mask, depth) in enumerate(frames):
        if i != 0:
            continue
        cpu.process_frame(mask, depth)
        same = sync_msgs[k] == cpu_msgs[-1]
        log(f"service {name}: card {sync_msgs[k]} cpu {cpu_msgs[-1]} "
            f"identical {same}")
        if not _same_message(sync_msgs[k], cpu_msgs[-1], SERVICE_FLOAT_TOL):
            raise RuntimeError(f"service {name}: card message "
                               f"{sync_msgs[k]} != cpu {cpu_msgs[-1]}")

    res = sync_outs[0]["result"]
    tall = [i + 1 for i, t in enumerate(res.leaf_selection.is_tall) if t]
    image = LeafVisualizer().render(stream[0][0], int(res.leaf_id),
                                    res.grasp_uv, res.grasp_xyz,
                                    res.pre_grasp_xyz, tall_leaves=tall)
    if image.shape != (H, W, 3) or not image.any():
        raise RuntimeError(f"visualizer rendered {image.shape}")
    log("phase 5: card messages match the CPU service; visualizer rendered")
    return counts


class FixedLenTok:
    """Fixed encode length (BOS plus N_TEXT - 1 ids) and an injective
    decode -> decimal, so that random weights give varied parsed scores.
    After the stub tokenizer of the JAX package's VLA service bench,
    which keeps the prompt's first bytes; those are the same for every
    candidate, so this one folds the whole prompt into its ids and ends
    with a hash of it: rows differ where the candidates do, and in
    their last token."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def encode(self, text):
        data = np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int64)
        n = N_TEXT - 2
        fold = np.zeros(-(-len(data) // n) * n, np.int64)
        fold[:len(data)] = data
        ids = fold.reshape(-1, n).sum(axis=0) % (self.vocab - 8) + 3
        mix = int((data * (1 + np.arange(len(data)))).sum())
        return [1] + ids.tolist() + [mix % (self.vocab - 8) + 3]

    def decode(self, ids):
        key = 0
        for i in ids:
            key = (key * 1000003 + int(i) + 1) % (10 ** 9)
        return f"0.{key:09d}"


def build_llava(torch, dev):
    """LlavaTorch at the LLaVA-1.6-Mistral-7B widths, every parameter
    drawn on the card in bf16 from seed 0 (no f32 copy anywhere):
    0.02 * randn, the norm gains 1 + 0.02 * randn (``init_random_``
    says why)."""
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     init_random_)
    cfg = LlavaTorchConfig(dtype="bfloat16", prefill_attn_impl="flash",
                           image_grid_pinpoints=VLA_PINPOINTS)
    t0 = time.perf_counter()
    model = LlavaTorch(cfg, device=dev, param_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    init_random_(model, gen, std=0.02)
    with torch.no_grad():
        model.image_newline.copy_(torch.as_tensor(
            0.02 * np.random.default_rng(7).standard_normal(cfg.hidden),
            dtype=torch.bfloat16))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 6: LlavaTorch {n_params / 1e9:.3f} G parameters in bf16 "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated) "
        f"built in {time.perf_counter() - t0:.1f} s")
    return model


def profile_rerank(torch, scorer, rgb, cands, instruction, phase):
    """Where a rerank's time goes: one profiled rerank, and one that stops
    after the prompt pass, so the difference is the nine decode steps;
    in each, the decode attention's kernels as the card ran them (a
    replayed graph's too)."""
    from torch.profiler import ProfilerActivity, profile
    prof_out = {}
    for name, new_tokens in (("rerank", 10), ("prompt_pass_only", 1)):
        scorer.max_new_tokens = new_tokens
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_in(torch)
            t0 = time.perf_counter()
            scorer.score(rgb, cands, instruction)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                       for ev in prof.key_averages()
                       if ev.device_type == torch.autograd.DeviceType.CUDA
                       and not is_lead_in(ev.key)), reverse=True)
        busy = sum(r[0] for r in rows)
        prof_out[name] = {
            "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall,
            "kernel_launches": sum(r[1] for r in rows),
            "flash_prefill_ms": sum(
                r[0] for r in rows
                if kernel_function(r[2]) in ("flash_prefill_kernel",
                                             "flash_prefill_f32_kernel")),
            "decode_attention_launches": sum(
                r[1] for r in rows if kernel_function(r[2]) in DECODE_KERNELS),
            "decode_attention_ms": sum(
                r[0] for r in rows if kernel_function(r[2]) in DECODE_KERNELS),
            "top": [{"ms": ms, "count": n, "name": key[:60]}
                    for ms, n, key in rows[:6]]}
        log(f"{phase} profile {name} {json.dumps(prof_out[name])}")
    scorer.max_new_tokens = 10
    steps = scorer.max_new_tokens - 1
    full, prompt = prof_out["rerank"], prof_out["prompt_pass_only"]
    prof_out["decode_step_launches"] = (full["kernel_launches"]
                                        - prompt["kernel_launches"]) / steps
    prof_out["decode_step_device_ms"] = (full["device_busy_ms"]
                                         - prompt["device_busy_ms"]) / steps
    log(f"{phase} profile: a decode step launches "
        f"{prof_out['decode_step_launches']} kernels and keeps the device "
        f"busy {prof_out['decode_step_device_ms']} ms (under the profiler)")
    return prof_out


def check_decode_attention(torch, dev):
    """Phase 6.1's decode attention at the 7B cell's step: five rows of the
    graph route's cache (2432 slots), the tenth token's slot 2409 of a
    2400-slot prompt, left pads as the cell's rows have them, 32 query
    heads over 8 of 128, bf16. The kernel against its plain version, its
    time (its two kernels' device time) beside its bound (the live
    keys' K and V bytes at 3.35 TB/s), the plain version's, and
    ``scaled_dot_product_attention``'s as a yardstick only (K and V
    repeated to the query heads before the timed call, the live keys by
    a boolean mask)."""
    import torch.nn.functional as F
    from leafgrasp_tpu_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    b, cap, heads, kvh, hd, pos = 5, 2432, 32, 8, 128, 2409
    pads = (0, 2, 5, 1, 3)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(61)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, k, v = draw(b, 1, heads, hd), draw(b, cap, kvh, hd), \
        draw(b, cap, kvh, hd)
    pad = torch.tensor(pads, dtype=torch.int32, device=dev)
    cursor = torch.tensor([pos], dtype=torch.int64, device=dev)

    def kernel():
        return decode_attention(q, k, v, pad, cursor, bf16)

    def plain():
        return decode_attention_plain(q, k, v, pad, cursor, bf16)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    over = float((diff - DECODE_TOL * (w.abs() + w.abs().amax(
        -1, keepdim=True))).max())
    if not over <= 0.0 or not bool(torch.isfinite(g).all()) \
            or not torch.equal(got, kernel()):
        raise RuntimeError(f"phase 6.1 decode attention: over the "
                           f"tolerance by {over}, or not deterministic")
    live = sum(pos + 1 - p for p in pads)
    moved = 2.0 * live * kvh * hd * 2      # K and V rows, bf16, read once
    key = torch.arange(cap, device=dev)
    mask = ((key[None, :] >= pad[:, None])
            & (key[None, :] <= pos))[:, None, None, :]
    rep = heads // kvh
    kr = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    vr = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    qs = q.transpose(1, 2)
    rec = {"name": "decode_attention", "route": "cuda",
           "source": "leafgrasp_tpu_torch/kernels/csrc/decode_attention.cu",
           "replaces": "none (the JAX decode's grouped einsum, "
                       "leafgrasp_tpu/vla/llava_jax.py:355-379)",
           "shape": [b, cap, pos, heads, kvh, hd], "pads": list(pads),
           "max_abs_err": float(diff.max()), "tolerance_rel": DECODE_TOL,
           "ms": kernel_ms(kernel, DECODE_KERNELS, iters=50),
           "event_ms": cuda_ms(kernel, iters=50),
           "bound_ms": moved / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bytes": moved, "plain_ms": cuda_ms(plain, iters=20),
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               qs, kr, vr, attn_mask=mask), iters=50)}
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"phase 6.1 decode attention {json.dumps(rec)}")
    return rec


def run_vla(torch, dev, cnn, scenes):
    """Phase 6: the VLA rerank serve path at full width."""
    from leafgrasp_tpu_torch.config import DEFAULT_CONFIG
    from leafgrasp_tpu_torch.io.scenes import default_projection
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    from leafgrasp_tpu_torch.utils.device import (host_reads,
                                                  reset_host_reads)
    from leafgrasp_tpu_torch.utils.profiler import StageTimer
    from leafgrasp_tpu_torch.vla.hybrid import HybridGraspSelector
    from leafgrasp_tpu_torch.vla.llava_next import (_pack_plan,
                                                    select_best_resolution)
    from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer
    from leafgrasp_tpu_torch.vla.processor import (TinyVLAScorer,
                                                   VLAProcessor)

    model = build_llava(torch, dev)
    layers = model.cfg.layers
    scorer = LlavaTorchScorer(model, FixedLenTok(model.cfg.vocab_size),
                              max_new_tokens=10, decode_mode="steps",
                              anyres=True)
    rgb = (np.random.default_rng(0).uniform(0, 255, (H, W, 3))
           .astype(np.uint8))
    best = select_best_resolution((H, W), VLA_PINPOINTS)
    pp, gw, gh, crop = _pack_plan((H, W), VLA_PINPOINTS, model.cfg)
    n_img_want = pp * pp + (crop[1] - crop[0]) * (crop[3] - crop[2] + 1)
    log(f"phase 6 geometry: frame {(H, W)} picks {best}, {1 + gw * gh} "
        f"tiles, grid {gh * pp}x{gw * pp} cropped to rows {crop[:2]} cols "
        f"{crop[2:]}, {n_img_want} image tokens + {N_TEXT} text tokens")
    rng = np.random.default_rng(3)
    cands = [dict(leaf_id=i + 1, x=float(rng.uniform(100, W - 100)),
                  y=float(rng.uniform(100, H - 100)),
                  clutter_score=float(rng.uniform(0.2, 1.0)),
                  distance_score=float(rng.uniform(0.2, 1.0)),
                  visibility_score=float(rng.uniform(0.2, 1.0)),
                  geometric_score=float(rng.uniform(0.2, 1.0)))
             for i in range(5)]
    instruction = "Select the best leaf for grasping"

    # 6.1 the scorer called directly: an exception propagates
    scorer.score(rgb, cands, instruction)              # warm-up, uncounted
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_host_reads()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scores = scorer.score(rgb, cands, instruction)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    flash_n = launch_counts()["flash_prefill"]
    last = dict(scorer.last)
    flash_tokens = last.pop("tokens")
    log(f"phase 6.1 rerank: scores {scores}; t {last['prompt_len']}, image "
        f"tokens {last['n_image_tokens']}, flash launches {flash_n}, host "
        f"reads {host_reads()}, wall {wall_ms} ms, encode "
        f"{last.get('encode_ms')} ms, prefill {last['prefill_ms']} ms, "
        f"decode {last['decode_ms']} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not (len(scores) == 5 and np.isfinite(scores).all()
            and len(set(scores)) > 1):
        raise RuntimeError(f"phase 6.1: bad scores {scores}")
    # the shared route: the image prefix once, then the rows' text, each
    # pass launching the flash kernel once a layer
    if flash_n != 2 * layers or last["prefill_route"] != "shared" \
            or last["n_image_tokens"] != n_img_want \
            or last["prompt_len"] != n_img_want + N_TEXT:
        raise RuntimeError(f"phase 6.1: {flash_n} flash launches, route "
                           f"{last['prefill_route']}, "
                           f"{last['n_image_tokens']} image tokens, t "
                           f"{last['prompt_len']}")

    if last["decode_attention"] != "kernel":
        raise RuntimeError(f"phase 6.1: the steps' attention ran "
                           f"{last['decode_attention']}")
    prof_out = profile_rerank(torch, scorer, rgb, cands, instruction,
                              "phase 6.1")
    # the replayed steps' attention, as the profile saw it: its scores and
    # pv kernels once a layer and step, none in the prompt pass
    steps = scorer.max_new_tokens - 1
    da_launches = prof_out["rerank"]["decode_attention_launches"]
    if da_launches != len(DECODE_KERNELS) * layers * steps \
            or prof_out["prompt_pass_only"]["decode_attention_launches"]:
        raise RuntimeError(
            f"phase 6.1: the profiled rerank ran {da_launches} decode "
            f"attention kernels, not {len(DECODE_KERNELS)} x {layers} "
            f"layers x {steps} steps")
    decode_attention = check_decode_attention(torch, dev)
    decode_attention["rerank_calls"] = da_launches // len(DECODE_KERNELS)
    decode_attention["rerank_kernel_launches"] = da_launches
    decode_attention["rerank_ms"] = \
        prof_out["rerank"]["decode_attention_ms"]
    log(f"phase 6.1 profile: the rerank's steps ran the decode attention's "
        f"kernels {da_launches} times "
        f"({decode_attention['rerank_ms']} ms)")
    perf = {"encode_ms": last.get("encode_ms"),
            "prefill_ms": last["prefill_ms"],
            "decode_ms": last["decode_ms"],
            "decode_step_device_ms": prof_out["decode_step_device_ms"],
            "decode_attention": decode_attention}

    # 6.2 the same candidates through the chunked route, and one by one
    def differing(a, b):
        return int((np.asarray(a) != np.asarray(b)).sum())

    from leafgrasp_tpu_torch.vla.processor import build_prompt
    feats, n_img = scorer._encode_image(rgb)
    ids = torch.as_tensor(
        [scorer._encode(build_prompt(c, instruction), n_img) for c in cands],
        device=dev)

    def first_logits():
        """The prompt pass alone, through the model's own entry: a
        causal mask, every row of one length."""
        return model(ids, image_features=feats.expand(len(cands), -1, -1),
                     logits_last_only=True)[0][:, -1].float()

    def traced_logits():
        """first_logits, and beside it the last position's hidden state
        after every layer as a (layers, b, hidden) tensor."""
        states = []
        hooks = [layer.register_forward_hook(
            lambda _m, _a, out: states.append(out[0][:, -1].float()))
            for layer in model.layers]
        try:
            logits = first_logits()
        finally:
            for hook in hooks:
                hook.remove()
        return logits, torch.stack(states)

    def share(a, b):
        """Largest difference as a share of b's standard deviation."""
        return float((a - b).abs().max() / b.std())

    reset_launch_counts()
    logits_flash, states_flash = traced_logits()
    if launch_counts()["flash_prefill"] != layers:
        raise RuntimeError("phase 6.2: the prompt pass did not take flash")
    logits_single = torch.cat([
        model(ids[i:i + 1], image_features=feats,
              logits_last_only=True)[0][:, -1].float()
        for i in range(len(cands))])
    delta_batch = share(logits_single, logits_flash)
    model.set_prefill_attn("chunked")
    reset_launch_counts()
    logits_chunked, states_chunked = traced_logits()
    chunked_scores = scorer.score(rgb, cands, instruction)
    chunked = dict(scorer.last)
    # the chunked route against itself at another chunk size: the same
    # PyTorch operations, only the shapes of the products differ
    chunk_was = model.cfg.prefill_attn_chunk
    model.set_prefill_attn("chunked", chunk=VLA_OTHER_CHUNK)
    logits_other, states_other = traced_logits()
    if launch_counts()["flash_prefill"] != 0:
        raise RuntimeError("phase 6.2: the chunked route launched flash")
    model.set_prefill_attn("flash", chunk=chunk_was)
    delta = share(logits_flash, logits_chunked)
    delta_other = share(logits_other, logits_chunked)
    growth = {
        str(n): {"flash": share(states_flash[n - 1], states_chunked[n - 1]),
                 "other_chunk": share(states_other[n - 1],
                                      states_chunked[n - 1])}
        for n in sorted({1, 2, 4, 8, 16, 24, layers}) if n <= layers}
    log(f"phase 6.2 growth of a route's difference from chunked "
        f"({chunk_was}) through the layers, last position's hidden state, "
        f"share of its deviation (limit after layer 1: "
        f"{VLA_MAX_LAYER1_DELTA}); other_chunk is chunked "
        f"({VLA_OTHER_CHUNK}): {json.dumps(growth)}")
    first_equal = int((logits_flash.argmax(-1)
                       == logits_chunked.argmax(-1)).sum())
    n_diff = differing(flash_tokens, chunked["tokens"])
    log(f"phase 6.2 flash against chunked: first-step logits differ by at "
        f"most {delta} of their standard deviation (limit "
        f"{VLA_MAX_LOGIT_DELTA}; chunked at {VLA_OTHER_CHUNK} against "
        f"chunked at {chunk_was}: {delta_other}; batched against one by "
        f"one on the flash route: {delta_batch}), {first_equal} of "
        f"{len(cands)} first tokens equal; {n_diff} of "
        f"{np.asarray(flash_tokens).size} greedy tokens differ (limit "
        f"{VLA_MAX_TOKEN_DIFF}); parsed scores differ:"
        f" {scores != chunked_scores}; chunked prefill "
        f"{chunked['prefill_ms']} ms, decode {chunked['decode_ms']} ms")
    if not (growth["1"]["flash"] <= VLA_MAX_LAYER1_DELTA
            and delta <= VLA_MAX_LOGIT_DELTA
            and n_diff <= VLA_MAX_TOKEN_DIFF):
        raise RuntimeError(
            f"phase 6.2: after one layer the routes differ by "
            f"{growth['1']['flash']} of the deviation (limit "
            f"{VLA_MAX_LAYER1_DELTA}), the logits by {delta}, {n_diff} "
            f"tokens differ")
    del states_flash, states_chunked, states_other, logits_other
    del logits_flash, logits_chunked, logits_single
    scorer.max_batch = 1
    reset_launch_counts()
    single_scores = scorer.score(rgb, cands, instruction)
    single = dict(scorer.last)
    scorer.max_batch = None
    perf["batched_vs_single_tokens_differ"] = differing(flash_tokens,
                                                        single["tokens"])
    log(f"phase 6.2 batched against one by one: "
        f"{perf['batched_vs_single_tokens_differ']} of 50 tokens differ; "
        f"parsed scores differ: {scores != single_scores}; flash launches "
        f"{launch_counts()['flash_prefill']}; prefill {single['prefill_ms']}"
        f" ms, decode {single['decode_ms']} ms for the five")
    if launch_counts()["flash_prefill"] != 5 * layers:
        raise RuntimeError("phase 6.2: one-by-one scoring did not launch "
                           "flash once per layer and candidate")

    # 6.3 the service with the rerank
    msgs = []
    svc = GraspService(DEFAULT_CONFIG, cnn=cnn,
                       hybrid_selector=HybridGraspSelector(
                           VLAProcessor(scorer)),
                       publish=msgs.append, min_interval_s=0.0,
                       pipeline_depth=0)
    svc.set_camera_params(default_projection())
    svc.on_rgb(rgb)
    fams = [scenes[name] for name, *_ in FAMILIES]

    def feed(i):
        mask, depth = fams[i % len(fams)]
        svc.on_mask(np.roll(mask, 3 * i, axis=1), stamp_us=i)
        svc.on_depth(np.roll(depth, 3 * i, axis=1), stamp_us=i)
        return svc.process_pending(force=True)

    for i in range(VLA_WARM_FRAMES):
        out = feed(i)
        if out is None or not out["found"] or out["vla"] is None:
            raise RuntimeError("phase 6.3: the warm-up frame has no VLA "
                               "choice")
    svc.timer = StageTimer()
    msgs.clear()
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_host_reads()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(VLA_WARM_FRAMES, VLA_WARM_FRAMES + VLA_FRAMES):
        before = launch_counts()["flash_prefill"]
        out = feed(i)
        rose = launch_counts()["flash_prefill"] - before
        if out is None or not out["found"] or out["vla"] is None \
                or not out["message"] or rose != 2 * layers:
            raise RuntimeError(
                f"phase 6.3 frame {i}: found "
                f"{out and out['found']}, vla {out and out['vla']}, flash "
                f"launches {rose}: a failure was swallowed")
        log(f"phase 6.3 frame {i}: leaf {out['vla']['leaf_id']} strategy "
            f"{out['vla']['strategy']} confidence "
            f"{out['vla']['vla_confidence']:.3f} message {out['message']}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stages = svc.stats()["stages"]
    if len(msgs) != VLA_FRAMES:
        raise RuntimeError(f"phase 6.3: {len(msgs)} messages for "
                           f"{VLA_FRAMES} frames")
    log(f"phase 6.3 VLA service: {VLA_FRAMES} frames in {wall:.3f} s, "
        f"{VLA_FRAMES / wall} frames/s; host reads per frame "
        f"{host_reads() / VLA_FRAMES}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
        f"{json.dumps(counts)}")
    log(f"phase 6.3 stages {json.dumps(stages)}")

    # 6.4 the two degradations, on purpose
    class Boom:
        def score(self, *a, **k):
            raise RuntimeError("backend failure injection")

    svc.hybrid_selector.processor.backend = Boom()
    out1 = feed(100)
    if not (out1 and out1["found"] and out1["vla"] is not None
            and out1["message"]):
        raise RuntimeError("phase 6.4: a failing backend must still give a "
                           "choice")
    log(f"phase 6.4 backend raises: strategy {out1['vla']['strategy']}, "
        f"confidence {out1['vla']['vla_confidence']:.3f}, message "
        f"published")

    class Raiser:
        def select_grasp_point(self, *a, **k):
            raise RuntimeError("selector failure injection")

    svc.hybrid_selector = Raiser()
    out2 = feed(101)
    if not (out2 and out2["found"] and out2["message"]
            and out2["vla"] is None):
        raise RuntimeError("phase 6.4: a failing selector must give the "
                           "geometric message with vla None")
    log("phase 6.4 selector raises: geometric message published, vla None")
    svc.stop()

    # 6.5 the small model through the same selector
    tiny = HybridGraspSelector(VLAProcessor(TinyVLAScorer(seed=0)))
    tiny_scores = tiny.processor.backend.score(rgb, cands, instruction)
    choice = tiny.select_grasp_point(rgb, cands)
    if choice is None or len(tiny_scores) != 5 \
            or not np.isfinite(tiny_scores).all():
        raise RuntimeError(f"phase 6.5: TinyVLAScorer gave {tiny_scores}")
    log(f"phase 6.5 TinyVLAScorer on the card: scores {tiny_scores}, "
        f"strategy {choice['strategy']}")
    del model, scorer, svc
    return counts, perf


# ---------------------------------------------------------------- phase 7 --

# (N, HW, C, R) of the gate's gradient: the four architectures at the
# training batch (lightweight, standard, deep, wide; R = C / 16)
GATE_TRAIN_SHAPES = {"lightweight": (16, 16, 128, 8),
                     "standard": (16, 16, 256, 16),
                     "deep": (16, 4, 256, 16), "wide": (16, 16, 512, 32)}
# N of one, past one cluster of blocks (the kernel's cluster holds up to
# 16) and the kernel's limits (HW 64, C 1024, R 64), checked beside them
GATE_EXTRA_SHAPES = {"n1": (1, 16, 256, 16), "n17": (17, 16, 256, 16),
                     "n33": (33, 16, 128, 8), "limits": (17, 64, 1024, 64)}
# dx against the plain version's, absolute; each parameter gradient's
# largest difference against 1e-5 of that gradient's L2 norm (the card
# sums the products over N, HW and C in another order)
GATE_DX_TOL = 1e-5
GATE_PARAM_REL_TOL = 1e-5
# each time of phase 7a is the median of this many profiles (single
# profiles of the gate's gradient read 0.0105-0.0153 ms in PR 7-9)
GATE_TIME_REPEATS = 5
# one train step of the standard CNN (dropout 0, same weights and batch)
# on the card against the CPU: each gradient's largest difference against
# 3e-5 of its L2 norm. cuDNN's f32 convolutions (TF32 off) and the CPU's
# sum the 16 x 32 x 32 positions of a weight's gradient in other orders,
# and the batch statistics of six BatchNorm layers pass that on (read on
# an H100: at most 3.0e-6)
TRAIN_GRAD_REL_TOL = 3e-5
PROFILE_STEPS = 20
# logits of the reloaded checkpoint against the trained model's, absolute
RELOAD_TOL = 1e-6
TEACHER_SCORE_TOL = 1e-5
TEACHER_FRAMES_PER_FAMILY = 2
TEACHER_MODE = "reference_self"
TEACHER_KERNELS = ("minplus_pass2", "fused_score_maps")
TRAIN_CORPUS = os.path.join("artifacts", "grasp_cnn_hard", "training_data",
                            "training_data.npz")
JAX_META = os.path.join("artifacts", "grasp_cnn_hard",
                        "best_model.meta.json")
# cut from 150 (the trainer's default) for the script's time
TRAIN_EPOCHS = 10
TRAIN_SEED = 42
TRAIN_OUT = os.path.join("build", "chip_smoke_train")


def _gate_params(torch, dev, rng, c, r):
    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale)
                               .astype(np.float32), device=dev)
    return (t(c, 1, scale=c ** -0.5), t(1), t(c, r, scale=c ** -0.5), t(r),
            t(r, c, scale=r ** -0.5), t(c))


def _rel_err(got, want) -> float:
    """Largest difference over the L2 norm of ``want`` (0 against 0 is
    0, anything else against 0 is infinite)."""
    err = (got - want).abs().max().item()
    norm = want.norm().item()
    if norm == 0.0:
        return 0.0 if err == 0.0 else float("inf")
    return err / norm


def check_attention_backward(torch, dev):
    """Phase 7a: the gate's gradient kernel against its plain version at
    the four architectures' training shapes, in the three gated modes,
    for x as the CNN passes it (the NCHW view) and contiguous, and for dy
    contiguous, channel-major and with stride 0 along HW (the average
    pool's gradient); twice, bit-equal; mode ``none`` passes dy through
    with no launch."""
    from leafgrasp_tpu_torch.kernels import LAUNCHES
    from leafgrasp_tpu_torch.kernels.attention import (
        attention_gate_backward, attention_gate_backward_plain,
        attention_gate_plain, fused_attention_gate)
    rng = np.random.default_rng(7)
    errs = {"dx": 0.0, "params_rel": 0.0}
    inputs = {}
    for arch, (n, hw, c, r) in {**GATE_TRAIN_SHAPES,
                                **GATE_EXTRA_SHAPES}.items():
        base = torch.relu(torch.as_tensor(
            rng.standard_normal((n, c, hw)).astype(np.float32), device=dev))
        params = _gate_params(torch, dev, rng, c, r)
        xs = {"nchw_view": base.transpose(1, 2),
              "contiguous": base.transpose(1, 2).contiguous()}
        g = torch.as_tensor(rng.standard_normal((n, hw, c))
                            .astype(np.float32), device=dev)
        pooled = torch.as_tensor(rng.standard_normal((n, 1, c))
                                 .astype(np.float32), device=dev) / hw
        dys = {"contiguous": g, "channel_major": g.transpose(1, 2)
               .contiguous().transpose(1, 2),
               "pool_stride0": pooled.expand(n, hw, c)}
        if dys["pool_stride0"].stride()[1] != 0:
            raise RuntimeError("the pooled dy is not stride 0 along HW")
        for xl, x in xs.items():
            for dyl, dy in dys.items():
                for mode in ("spatial", "channel", "hybrid"):
                    got = attention_gate_backward(dy, x, *params, mode)
                    again = attention_gate_backward(dy, x, *params, mode)
                    want = attention_gate_backward_plain(dy, x, *params,
                                                         mode)
                    torch.cuda.synchronize()
                    key = f"{arch}/{xl}/{dyl}/{mode}"
                    if not all(torch.equal(a, b)
                               for a, b in zip(got, again)):
                        raise RuntimeError(f"gate backward {key}: two runs "
                                           f"differ")
                    dx_err = (got[0] - want[0]).abs().max().item()
                    rel = max(_rel_err(a, b)
                              for a, b in zip(got[1:], want[1:]))
                    errs["dx"] = max(errs["dx"], dx_err)
                    errs["params_rel"] = max(errs["params_rel"], rel)
                    if dx_err > GATE_DX_TOL or rel > GATE_PARAM_REL_TOL:
                        raise RuntimeError(f"gate backward {key}: dx err "
                                           f"{dx_err}, parameter rel err "
                                           f"{rel}")
        inputs[arch] = (xs["nchw_view"], dys["pool_stride0"], params)
    # mode none: no gate, dy passes through, nothing launches
    x, dy, params = inputs["standard"]
    xg = x.detach().clone().requires_grad_()
    before = dict(LAUNCHES)
    (dx_none,) = torch.autograd.grad(
        fused_attention_gate(xg, *params, "none"), xg, dy)
    if not torch.equal(dx_none, dy) or dict(LAUNCHES) != before:
        raise RuntimeError("gate backward, mode none: dx != dy or a launch")
    log(f"phase 7a: gate backward matches its plain version at "
        f"{sorted(GATE_TRAIN_SHAPES)} and {sorted(GATE_EXTRA_SHAPES)} x 2 "
        f"x layouts 3 dy forms x 3 modes, bit-equal run to run; max dx "
        f"err {errs['dx']:.3e}, max parameter err / norm "
        f"{errs['params_rel']:.3e}")

    # times at the main path's shape and mode: standard, spatial, x the
    # NCHW view, dy the pool's stride-0 gradient
    def plain_grad():
        xp = x.detach().requires_grad_()
        ps = [p.detach().requires_grad_() for p in params]
        return torch.autograd.grad(attention_gate_plain(xp, *ps, "spatial"),
                                   [xp, *ps], dy, allow_unused=True)
    def median_ms(fn, kernel):
        reps = [kernel_ms(fn, kernel) for _ in range(GATE_TIME_REPEATS)]
        return statistics.median(reps), reps

    modes_ms = {}
    for mode in ("spatial", "channel", "hybrid"):
        ms, reps = median_ms(lambda: attention_gate_backward(
            dy, x, *params, mode), "attention_gate_backward_kernel")
        modes_ms[mode] = {
            "ms": ms, "ms_repeats": reps,
            "wrapper_ms": cuda_ms(lambda: attention_gate_backward(
                dy, x, *params, mode))}
    # one launch a call: a profile of one call holds one kernel and no
    # memset or copy
    ran = device_kernels(lambda: attention_gate_backward(dy, x, *params,
                                                         "spatial"))
    if [kernel_function(k) for k in ran] != \
            ["attention_gate_backward_kernel"]:
        raise RuntimeError(f"phase 7a: one call of the gate's gradient ran "
                           f"{ran} on the card")
    # the floors beside it: an empty launch (a one-element fill) and K2's
    # forward at the same shape (one read of x, one write)
    with torch.no_grad():
        fwd_ms, fwd_reps = median_ms(
            lambda: fused_attention_gate(x, *params, "spatial"),
            "fused_attention_gate_kernel")
    floor = launch_floor_ms(torch, dev)
    log(f"phase 7a: one call of the gate's gradient ran {ran}; floors at "
        f"the same shape: an empty launch {floor[0]} ms {floor[1]}, K2's "
        f"forward {fwd_ms} ms {fwd_reps}")
    plain_ms = cuda_ms(plain_grad)
    n, hw, c, r = GATE_TRAIN_SHAPES["standard"]
    # x read once, dy's N*C stored values once, the gate's parameters
    # once; dx and the parameter gradients written once. Operations: the
    # recomputed gate (3 an element), dz (3), dx (5), dws (2)
    b_ms, b_by = bound(4 * (2 * n * hw * c + n * c + 2 * (c + 1)),
                       13.0 * n * hw * c)
    rec = {"name": "attention_gate_backward", "route": "cuda",
           "source": "leafgrasp_tpu_torch/kernels/csrc/attention.cu",
           "replaces": "XLA autodiff of "
                       "leafgrasp_tpu/models/attention_pallas.py:26-39",
           "tolerance": {"dx_abs": GATE_DX_TOL,
                         "param_rel_norm": GATE_PARAM_REL_TOL},
           "max_abs_err": errs["dx"], "max_param_err_rel": errs["params_rel"],
           "ms": modes_ms["spatial"]["ms"],
           "ms_repeats": modes_ms["spatial"]["ms_repeats"],
           "wrapper_ms": modes_ms["spatial"]["wrapper_ms"],
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, "modes_ms": modes_ms,
           "kernels_a_call": len(ran), "empty_launch_ms": floor[0],
           "forward_ms": fwd_ms}
    log(f"attention_gate_backward {json.dumps(rec)}")
    return rec


def run_teacher(torch, dev, scenes):
    """Phase 7b: the teacher labels 1080 x 1440 frames of the bench
    families on the card and feeds the collector; the first frame's
    teacher point, score and negative pools against the CPU path."""
    import tempfile
    from leafgrasp_tpu_torch.config import (DEFAULT_CONFIG,
                                            GraspScoringConfig)
    from leafgrasp_tpu_torch.geometry.leaf_scorer import select_optimal_leaf
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.training import (GraspDataCollector,
                                              collect_from_frames,
                                              teacher_select, verify_dataset)
    cfg = DEFAULT_CONFIG.replace(
        grasp=GraspScoringConfig(isolation_context=TEACHER_MODE))
    frames = [(np.roll(scenes[name][0], 3 * i, axis=1),
               np.roll(scenes[name][1], 3 * i, axis=1))
              for name, *_ in FAMILIES
              for i in range(TEACHER_FRAMES_PER_FAMILY)]
    work = tempfile.mkdtemp(dir="build")
    coll = GraspDataCollector(os.path.join(work, "card"), resume=False,
                              seed=0, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    used = collect_from_frames(frames, coll, CX, CY, F, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    missing = [k for k in TEACHER_KERNELS if counts[k] == 0]
    if missing:
        raise RuntimeError(f"phase 7b: the teacher launched no {missing}")
    report = verify_dataset(coll.dataset())
    if used != len(frames) or not report["ok"]:
        raise RuntimeError(f"phase 7b: {used} of {len(frames)} frames used, "
                           f"dataset report {report['problems']}")
    log(f"phase 7b: teacher on {len(frames)} {H}x{W} frames "
        f"({TEACHER_MODE}) in {wall:.3f} s ({wall / len(frames) * 1e3:.1f} "
        f"ms a frame with the collector); stats {json.dumps(coll.stats)}; "
        f"launches {json.dumps(counts)}")

    # the first frame on both devices
    mask, depth = frames[0]
    picks = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m = torch.as_tensor(mask, device=d).to(torch.int32)
        dep = torch.as_tensor(depth, device=d)
        sel = select_optimal_leaf(m, dep, *(torch.tensor(np.float32(v),
                                                         device=d)
                                            for v in (CX, CY, F)),
                                  cfg=cfg.leaf, frame=cfg.frame)
        leaf = m == sel.best_leaf_id
        point, total, _ = teacher_select(leaf, m > 0, dep, CX, CY, F, cfg,
                                         device=d)
        pools = GraspDataCollector(os.path.join(work, name), resume=False,
                                   device=d).negative_pools(leaf)
        picks[name] = (int(sel.best_leaf_id), point, total,
                       [[(int(x), int(y)) for x, y in p] for p in pools])
    card, cpu = picks["card"], picks["cpu"]
    if card[:2] != cpu[:2] or abs(card[2] - cpu[2]) > TEACHER_SCORE_TOL \
            or card[3] != cpu[3]:
        raise RuntimeError(f"phase 7b: card (leaf, point, score) "
                           f"{card[:3]} != cpu {cpu[:3]} or the pools differ")
    log(f"phase 7b: first frame on card and CPU: leaf {card[0]}, teacher "
        f"point {card[1]}, score {card[2]:.7f} / {cpu[2]:.7f}; pools "
        f"(tip, stem, edge) of {[len(p) for p in card[3]]} points equal")
    return counts


def _corpus():
    data = np.load(TRAIN_CORPUS)
    return {k: data[k] for k in data.files}


def check_train_step(torch, dev, dataset):
    """Phase 7c, first: one train step of the standard CNN, dropout 0,
    from the same weights and batch on the card and on the CPU; every
    parameter must get a finite gradient that agrees with the CPU's."""
    from leafgrasp_tpu_torch.config import ModelConfig, TrainConfig
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      batchnorm_fed_biases,
                                                      init_like_flax_)
    from leafgrasp_tpu_torch.training.train import (bce_with_logits,
                                                    normalize_dataset)
    bs = TrainConfig().batch_size
    dn, sn, _ = normalize_dataset(
        torch.as_tensor(dataset["depth_patches"][:bs]),
        torch.as_tensor(dataset["score_patches"][:bs]))
    maskp = torch.as_tensor(dataset["mask_patches"][:bs])
    feats = torch.cat([dn[..., None], maskp[..., None],
                       sn.permute(0, 2, 3, 1)], dim=-1)
    labels = torch.as_tensor(dataset["labels"][:bs].astype(np.float32))
    cfg = ModelConfig(conv_dropout=0.0, fc_dropout=(0.0, 0.0, 0.0))
    cpu = init_like_flax_(GraspPointCNN(cfg),
                          torch.Generator().manual_seed(TRAIN_SEED))
    card = copy.deepcopy(cpu).to(dev)
    grads, counts = {}, None
    torch.cuda.synchronize()
    reset_launch_counts()
    for name, model, d in (("card", card, dev),
                           ("cpu", cpu, torch.device("cpu"))):
        model.train()
        loss = bce_with_logits(model(feats.to(d)), labels.to(d), 2.0)
        loss.backward()
        grads[name] = {k: p.grad for k, p in model.named_parameters()}
        if counts is None:
            torch.cuda.synchronize()
            counts = launch_counts()
    if counts["fused_attention_gate"] != 1 \
            or counts["attention_gate_backward"] != 1:
        raise RuntimeError(f"phase 7c: one step launched the gate "
                           f"{counts['fused_attention_gate']} and its "
                           f"backward {counts['attention_gate_backward']} "
                           f"times, not once each")
    errs = {}
    bn_fed = batchnorm_fed_biases(cpu)
    for k, g_cpu in grads["cpu"].items():
        g = grads["card"][k]
        if g is None or not torch.isfinite(g).all():
            raise RuntimeError(f"phase 7c: parameter {k} has no finite "
                               f"gradient on the card: {g}")
        if k in bn_fed:
            # its exact gradient is 0 (the batch mean cancels it); both
            # devices give rounding noise, held against the layer's weight
            ref = grads["cpu"][k[:-len("bias")] + "weight"]
            errs[k] = (g.cpu() - g_cpu).abs().max().item() / ref.norm().item()
        else:
            if not g.abs().max().item() > 0:
                raise RuntimeError(f"phase 7c: parameter {k} has a zero "
                                   f"gradient on the card")
            errs[k] = _rel_err(g.cpu(), g_cpu)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    if worst[0][1] > TRAIN_GRAD_REL_TOL:
        raise RuntimeError(f"phase 7c: gradients differ from the CPU's: "
                           f"{worst[:5]}")
    log(f"phase 7c: one train step, every one of {len(grads['cpu'])} "
        f"parameters (encoder, gate, dense, head) has a finite gradient on "
        f"the card; largest differences from the CPU's, over the norm "
        f"{json.dumps(dict(worst[:6]))}; gate forward and backward "
        f"launched once each")


def profile_train_step(torch, dev, dataset):
    """Device busy time and launches of one train step (standard CNN,
    batch 16, after warm-up steps)."""
    from torch.profiler import ProfilerActivity, profile
    from leafgrasp_tpu_torch.config import ModelConfig, TrainConfig
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      init_like_flax_)
    from leafgrasp_tpu_torch.training.train import (make_optimizer,
                                                    make_train_step)
    tcfg = TrainConfig()
    bs = tcfg.batch_size
    model = init_like_flax_(GraspPointCNN(ModelConfig()),
                            torch.Generator().manual_seed(TRAIN_SEED)).to(dev)
    step = make_train_step(model, make_optimizer(model, tcfg), tcfg)
    feats = torch.randn((bs, 32, 32, 9), device=dev)
    labels = (torch.arange(bs, device=dev) % 2).to(torch.float32)
    ones = torch.ones(bs, device=dev)
    for _ in range(5):
        step(feats, labels, ones, tcfg.pos_weight)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        step(feats, labels, ones, tcfg.pos_weight)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        t0 = time.perf_counter()
        step(feats, labels, ones, tcfg.pos_weight)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the optimizer's range annotation spans kernels too
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and not ev.is_user_annotation and not is_lead_in(ev.name):
            rec = by_name.setdefault(ev.name, [0.0, 0])
            rec[0] += ev.self_device_time_total / 1e3
            rec[1] += 1
    kernels = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    out = {"step_ms_unprofiled": step_ms, "wall_ms": wall_ms,
           "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms if busy else None,
           "kernel_launches": sum(k[1] for k in kernels),
           "top": [{"ms": ms, "count": n, "name": name[:80]}
                   for ms, n, name in kernels[:8]]}
    log(f"phase 7c profile of one train step {json.dumps(out)}")
    if not busy:
        raise RuntimeError("phase 7c: the profiled step ran nothing on the "
                           "card")
    return out


def run_training(torch, dev):
    """Phase 7c: the trainer on the card (standard CNN from
    ``init_like_flax_`` with seed 42, the stored corpus, the TrainConfig
    defaults, TRAIN_EPOCHS epochs), then a checkpoint reloaded through
    ``GraspQualityPredictor``."""
    from leafgrasp_tpu_torch.config import ModelConfig, TrainConfig
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.models.predictor import GraspQualityPredictor
    from leafgrasp_tpu_torch.training import (Trainer, save_checkpoint)
    from leafgrasp_tpu_torch.training.checkpoint import best_model_path
    dataset = _corpus()
    check_train_step(torch, dev, dataset)
    tcfg = TrainConfig(seed=TRAIN_SEED)
    with open(JAX_META) as f:
        jax_meta = json.load(f)
    jax_f1 = jax_meta["metrics"]["f1_score"]
    epoch_end = []

    def log_epoch(**kw):
        torch.cuda.synchronize()
        epoch_end.append(time.perf_counter())
        log(f"phase 7c epoch {kw['epoch']}: train_loss "
            f"{kw['train_loss']:.5f} val_loss {kw['val_loss']:.5f} val F1 "
            f"{kw['f1_score']:.2f} (lr {kw['lr']:.2e}; the JAX package's "
            f"checkpoint: F1 {jax_f1:.2f} at epoch {jax_meta['epoch']})")

    trainer = Trainer(ModelConfig(), tcfg, device=None)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = trainer.fit(dataset, epochs=TRAIN_EPOCHS, log_fn=log_epoch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n = len(dataset["labels"])
    n_train = int((1.0 - tcfg.val_fraction) * n)
    steps = -(-n_train // tcfg.batch_size)
    n_val_batches = -(-(n - n_train) // tcfg.batch_size)
    epochs = len(res.history["val_loss"])
    if counts["attention_gate_backward"] != steps * epochs \
            or counts["fused_attention_gate"] \
            != (steps + n_val_batches) * epochs:
        raise RuntimeError(f"phase 7c: {epochs} epochs of {steps} steps "
                           f"launched the gate backward "
                           f"{counts['attention_gate_backward']} times and "
                           f"its forward {counts['fused_attention_gate']}")
    first_val = res.history["val_loss"][0]
    if not res.best_val_loss < first_val:
        raise RuntimeError(f"phase 7c: best val loss {res.best_val_loss} "
                           f"not below the first epoch's {first_val}")
    ep_s = [b - a for a, b in zip([t0] + epoch_end[:-1], epoch_end)]
    med = statistics.median(ep_s)
    perf = {"epochs": epochs, "steps_per_epoch": steps,
            "fit_s": wall, "epoch_s": ep_s, "median_epoch_s": med,
            "steps_per_s": steps / med,
            "samples_per_s": steps * tcfg.batch_size / med,
            "best_epoch": res.best_epoch, "best_val_loss": res.best_val_loss,
            "first_val_loss": first_val,
            "best_f1": res.metrics["f1_score"],
            "best_f1_calibrated": res.metrics["calibrated"]["f1_score"],
            "jax_checkpoint_f1": jax_f1, "jax_checkpoint_epoch":
                jax_meta["epoch"]}
    log(f"phase 7c: trained {json.dumps(perf)}; launches "
        f"{json.dumps(counts)}")

    path = save_checkpoint(best_model_path(TRAIN_OUT),
                           res.model.state_dict(),
                           optimizer_state=res.optimizer_state,
                           norm_stats=res.norm_stats, metrics=res.metrics,
                           history=res.history, epoch=res.best_epoch)
    pred = GraspQualityPredictor(ModelConfig(), device=None).load(path)
    feats = torch.randn((64, 32, 32, 9), generator=torch.Generator()
                        .manual_seed(1)).to(dev)
    with torch.no_grad():
        want = res.model.eval()(feats)
        got = pred.model(feats)
    diff = (got - want).abs().max().item()
    stats_ok = all(np.array_equal(pred.norm_stats[k], getattr(
        res.norm_stats, k).cpu().numpy()) for k in res.norm_stats._fields)
    if diff > RELOAD_TOL or not stats_ok:
        raise RuntimeError(f"phase 7c: the reloaded checkpoint's logits "
                           f"differ by {diff} or its norm stats differ")
    log(f"phase 7c: checkpoint {path} reloaded through "
        f"GraspQualityPredictor: logits within {diff:.1e}, norm stats equal")
    perf["profile"] = profile_train_step(torch, dev, dataset)
    return counts, perf


# ---------------------------------------------------------------- phase 8 --

# (b, t, heads, kv_heads, hd), left pads, the scale of q and k, and the
# slack of the forward's log-sum-exp of the flash prefill's backward
# against its plain version: the training shape (the stub tokenizer's 642
# tokens, no pad: the trainer pads on the right), a tile, no multiple of
# one, head size 64, one to four query heads a K/V head, pads inside and
# across a 64-row tile and a row of pad only, and q and k at 8 times unit
# scale (|S / sqrt(hd)| in the tens: an error of the split products in S
# enters the exponent); K/V read through the strides of a longer cache
# that holds NaN beyond t.
# The log-sum-exp is held to FLASH_LSE_TOL plus that many f32 ulps of the
# row's largest sum_d |q_d k_d| scale: kernel and plain version sum S
# over hd in f32 in other orders, and at 8 times unit scale those terms
# sum to some 500, where an ulp is 3.1e-5 to 6.1e-5 (t257_x8 read 3.05e-5
# in f32 and 1.07e-4 in bf16 on an H100); every other case takes no slack
FLASH_BWD_SHAPES = {"train": ((2, 642, 32, 8, 128), (0, 0), 1.0, 0),
                    "t128": ((2, 128, 8, 2, 128), (0, 64), 1.0, 0),
                    "t200_rep1": ((3, 200, 8, 8, 128), (0, 37, 200), 1.0, 0),
                    "hd64_rep4": ((2, 200, 8, 2, 64), (5, 130), 1.0, 0),
                    "rep2": ((2, 333, 8, 4, 128), (70, 0), 1.0, 0),
                    "t257_x8": ((2, 257, 8, 2, 128), (0, 100), 8.0, 4)}
FLASH_LSE_TOL = 1e-5
FLASH_BWD_SERVING = ((5, 2400, 32, 8, 128), (0, 0, 0, 0, 0), 1.0, 0)
# The f32 forward's output against the plain version (phase 8a, beside
# phase 2's shapes): FLASH_TOL["float32"], and at q, k x 8 also what
# that many f32 ulps of the row's score terms in S move an output by
# (score_slack): kernel and plain version sum S over hd in f32 in other
# orders, which between two near-equal top scores moves an output by up
# to 1e-4, as far as the plain f32 version is from float64 there
# (tests/test_torch_flash_split.py). Forward-only cases at q, k x 8 beside
# t257_x8: the training shape and head size 64
FLASH_FWD_SLACK_ULPS = 4
FLASH_FWD_X8 = {"train_x8": ((2, 642, 32, 8, 128), (0, 5)),
                "hd64_x8": ((2, 128, 4, 2, 64), (0, 64))}
# the bf16 products the f32 forward issues a visible (query, key) pair
# and head: S = Q K^T over three planes of each (six), O += P V with P in
# two planes and V in three (five); the formulas' two
FLASH_FWD_PLANE_PRODUCTS = 6 + 5
# the products of the formulas a visible (query, key) pair and head, of
# 2 hd operations each: S, dP and dQ = dS K; S, dP, dV = P^T dO and
# dK = dS^T Q. The bound counts these at the bf16 tensor cores' rate
FLASH_BWD_PRODUCTS = {"dq": 3, "dkv": 4}
# the bf16 products the kernels issue for them: f32 inputs take S = Q K^T
# in three bf16 planes (six plane products) and the other products in two
# (three); bf16 inputs take S and dP as they are and split P and dS in two
# planes (two products each). Only ``issued_bound_ms`` counts these
FLASH_BWD_PLANE_PRODUCTS = {
    "float32": {"dq": 6 + 3 + 3, "dkv": 6 + 3 + 3 + 3},
    "bfloat16": {"dq": 1 + 1 + 2, "dkv": 1 + 1 + 2 + 2}}
# each gradient's largest difference from the plain backward's over its L2
# norm: both take the same inputs, output and log-sum-exp and compute in
# f32 (bf16 inputs widened), in other orders of the sums
FLASH_BWD_REL_TOL = 1e-5
# each time of phase 8a is the median of this many profiles
FLASH_BWD_TIME_REPEATS = 3
# phase 8b: LlavaLoRATrainer at the LLaVA-1.6-Mistral-7B widths (single
# tile), the reference's peft settings, the trainer's own defaults
TRAIN_MAX_LEN = 768
TRAIN_BATCH = 2
TRAIN_LR = 5e-5
TRAIN_SCENES = 4
TRAIN_CANDIDATES = 5
# five more steps on one batch: after Adam's first step the loss must fall
# at every step and end below the first. At the trainer's rate the batch
# read 2.16, 3.51, 2.00, 1.34, 0.93 (H100): the first step moves every one
# of the 10.5 M lora_b elements by about the rate at once. At lr 1e-3 it
# read 2.16, 19.6, 11.5, 26.8, 17.2 and did not fall (ROADMAP C)
OVERFIT_STEPS = 5
OVERFIT_LR = TRAIN_LR
# the first step's adapter gradients, flash route against chunked: the
# largest difference over each leaf's L2 norm. The routes differ by more
# than the kernels' sums: the first layer's input is bf16 (the embedding
# and its norm are bf16; the f32 adapters promote everything after their
# first product), and the chunked route rounds that layer's probabilities
# to the input's type before the second product, as the JAX module does,
# while the flash route's kernel takes q, k, v in the promoted f32 and
# never rounds them. Read 1.29e-4 at most over the 224 lora_b leaves in
# three runs on an H100; the limit is about 8 times that
TRAIN_ROUTE_REL_TOL = 1e-3
# logits of the reloaded adapter against the trained model's, absolute
ADAPTER_RELOAD_TOL = 0.0


class ByteStubTok:
    """The JAX package's test tokenizer for the LLaVA trainer
    (tests/test_llava_jax.py): a BOS id, then each byte of the text
    folded into the vocabulary, at most 60; ``decode`` a fixed decimal."""

    def encode(self, text):
        return [1] + [b % 90 + 2 for b in text.encode()][:60]

    def decode(self, ids):
        return "0.5"


def _flash_bwd_case(torch, dev, dtype, shape, pads, rng, qk_mul=1.0):
    b, t, heads, kvh, hd = shape

    def t_(*s, mul=1.0):
        return torch.as_tensor((rng.standard_normal(s) * mul)
                               .astype(np.float32), device=dev).to(dtype)

    q = t_(b, t, heads, hd, mul=qk_mul)
    ck, cv = t_(b, t + 10, kvh, hd, mul=qk_mul), t_(b, t + 10, kvh, hd)
    ck[:, t:] = float("nan")
    cv[:, t:] = float("nan")
    pad = torch.tensor(pads, dtype=torch.int32, device=dev)
    return q, ck, cv, pad, t_(b, t, heads, hd)


def _score_terms(torch, q, k, t):
    """(b, heads, t): the largest over a row's keys of sum_d |q_d k_d|
    times the scale, the size of what an f32 sum of S scale adds up."""
    rep = q.shape[2] // k.shape[2]
    kk = k[:, :t].float().abs().repeat_interleave(rep, dim=2)
    terms = torch.einsum("bihd,bjhd->bhij", q.float().abs(), kk)
    return terms.amax(-1) * q.shape[3] ** -0.5


def _score_slack(torch, q, k, v, pad, ulps, chunk=128):
    """(b, t, heads, hd): how far ``ulps`` f32 ulps of each row's score
    terms (``_score_terms``) in S scale move an output: a change d_j of
    S_j scale moves O_i by sum_j P_ij d_j (v_j - O_i), so by at most
    max |d| sum_j P_ij |v_j - O_i|, which is 0 for a one-hot row."""
    b, t, heads, hd = q.shape
    rep = heads // k.shape[2]
    kf = k[:, :t].float().repeat_interleave(rep, 2)
    vf = v[:, :t].float().repeat_interleave(rep, 2)
    key = torch.arange(t, device=q.device)
    spread = torch.zeros((b, t, heads, hd), device=q.device)
    for lo in range(0, t, chunk):
        hi = min(t, lo + chunk)
        s = torch.einsum("bihd,bjhd->bhij", q[:, lo:hi].float(), kf) \
            / hd ** 0.5
        vis = (key[None, None, :] <= key[lo:hi][None, :, None]) \
            & (key[None, None, :] >= pad.to(torch.int64)[:, None, None])
        s = s.masked_fill(~vis[:, None], float("-inf"))
        p = torch.nan_to_num(torch.softmax(s, -1))      # pad rows: 0
        o = torch.einsum("bhij,bjhd->bihd", p, vf)
        for h in range(heads):
            dev = (vf[:, None, :, h] - o[:, :, None, h]).abs()
            spread[:, lo:hi, h] = torch.einsum("bij,bijd->bid", p[:, h], dev)
    return ulps * 2.0 ** -23 \
        * _score_terms(torch, q, k, t).transpose(1, 2)[..., None] * spread


def _f32_forward_err(torch, q, k, v, pad, out, want, ulps):
    """(largest |out - want| on real rows, largest amount by which it
    exceeds FLASH_TOL["float32"] plus the slack of ``ulps``: <= 0
    passes)."""
    t = q.shape[1]
    real = (torch.arange(t, device=q.device)[None, :]
            >= pad.to(torch.int64)[:, None])[:, :, None, None]
    diff = (out - want).abs() * real
    slack = _score_slack(torch, q, k, v, pad, ulps) if ulps else 0.0
    over = (diff - FLASH_TOL["float32"]["abs"] - slack).max().item()
    return diff.max().item(), over


def _flash_bwd_bounds(shape, pads, dtype):
    """{"dq" or "dkv": (bytes, operations, bound ms, bound_by, issued
    operations, issued bound ms)}: each input read once and each output
    written once; per visible (query, key) pair and head, 2 hd operations
    for each product of the formulas (FLASH_BWD_PRODUCTS), at the tensor
    cores' bf16 rate, for f32 and bf16 inputs alike. The issued bound
    counts the bf16 products the split issues instead
    (FLASH_BWD_PLANE_PRODUCTS) at the same rate."""
    b, t, heads, kvh, hd = shape
    name = str(dtype).split(".")[1]
    dtype_bytes = 4 if name == "float32" else 2
    pairs = sum((t - p) * (t - p + 1) / 2 for p in pads) * heads
    qo = b * t * heads * hd
    kv = b * t * kvh * hd
    rows = b * heads * t * 4.0
    dq_bytes = dtype_bytes * (3 * qo + 2 * kv) + 2 * rows + 4.0 * qo
    dkv_bytes = dtype_bytes * (2 * qo + 2 * kv) + 2 * rows + 8.0 * kv
    out = {}
    for kind, moved in (("dq", dq_bytes), ("dkv", dkv_bytes)):
        ops = FLASH_BWD_PRODUCTS[kind] * 2.0 * hd * pairs
        issued = FLASH_BWD_PLANE_PRODUCTS[name][kind] * 2.0 * hd * pairs
        ms, by = bound(moved, ops, PEAK_BF16_OPS_PER_S)
        issued_ms, _ = bound(moved, issued, PEAK_BF16_OPS_PER_S)
        out[kind] = (moved, ops, ms, by, issued, issued_ms)
    return out


def check_f32_forward(torch, name, q, k, v, pad, out, want, ulps):
    """The f32 forward's output (``out``, launched with the log-sum-exp)
    and a launch without it against the plain version's ``want``: both
    within FLASH_TOL["float32"] plus the slack of ``ulps`` on real rows,
    pad rows exactly 0; two launches without it bit-equal. Returns the
    largest error and excess."""
    from leafgrasp_tpu_torch.kernels.flash_prefill import flash_prefill
    plain_out = flash_prefill(q, k, v, pad)
    again = flash_prefill(q, k, v, pad)
    torch.cuda.synchronize()
    if not torch.equal(plain_out, again):
        raise RuntimeError(f"phase 8a {name}: two f32 forwards differ")
    res = {}
    for label, got in (("lse", out), ("no_lse", plain_out)):
        err, over = _f32_forward_err(torch, q, k, v, pad, got, want, ulps)
        zero = all(not got[i, :p].any() for i, p in enumerate(pad.tolist()))
        if not (over <= 0.0 and zero and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"phase 8a {name} f32 forward {label}: err "
                               f"{err}, over the limit by {over}, pad rows "
                               f"zero {zero}")
        res[label] = (err, over)
    log(f"phase 8a f32 forward {name} {tuple(q.shape)} over "
        f"{k.shape[2]} K/V heads: max abs err with / without the lse "
        f"{res['lse'][0]:.3e} / {res['no_lse'][0]:.3e}, over the limit by "
        f"{res['lse'][1]:.3e} / {res['no_lse'][1]:.3e} (slack {ulps} ulps; "
        f"<= 0 passes), outputs bit-equal {torch.equal(out, plain_out)}")
    return {"err": max(e for e, _ in res.values()),
            "over": max(o for _, o in res.values()), "ulps": ulps}


def _flash_fwd_bound(shape, elem: int):
    """(bytes, operations, bound ms, bound_by) of the training forward
    with its log-sum-exp, no pad: q, k, v read once, the output and the
    log-sum-exp written once; the two products of 2 hd operations a
    visible (query, key) pair and head at the bf16 tensor cores' rate."""
    b, t, heads, kvh, hd = shape
    moved = elem * (2.0 * b * t * heads * hd + 2.0 * b * t * kvh * hd) \
        + 4.0 * b * heads * t + 4.0 * b
    ops = 2 * 2.0 * hd * b * t * (t + 1) / 2 * heads
    return (moved, ops, *bound(moved, ops, PEAK_BF16_OPS_PER_S))


def f32_forward_record(t_f32, fwd_errs) -> dict:
    """The f32 forward (K7-f32) at the training shape: times with and
    without the log-sum-exp, bounds (bytes; the split's issued bf16
    products), the plain version's and SDPA's f32 forward's times, and
    the largest errors of phase 8a (phase 2's are added in ``main``)."""
    moved, ops, b_ms, b_by = _flash_fwd_bound(t_f32["shape"], 4)
    issued = FLASH_FWD_PLANE_PRODUCTS * ops / 2
    unit = [e["err"] for e in fwd_errs.values() if e["ulps"] == 0]
    x8 = [e for e in fwd_errs.values() if e["ulps"] > 0]
    return {"name": "flash_prefill_f32", "route": "cuda",
            "kernel": "flash_prefill_f32_kernel",
            "source": "leafgrasp_tpu_torch/kernels/csrc/flash_prefill.cu",
            "replaces": "leafgrasp_tpu/vla/llava_jax.py:284",
            "shape": t_f32["shape"], "dtype": "float32",
            "ms": t_f32["forward_ms"],
            "ms_repeats": t_f32["forward_ms_repeats"],
            "lse_ms": t_f32["forward_lse_ms"],
            "lse_ms_repeats": t_f32["forward_lse_ms_repeats"],
            "bound_ms": b_ms, "bound_by": b_by, "bytes": moved,
            "operations": ops,
            "issued_bound_ms": bound(moved, issued, PEAK_BF16_OPS_PER_S)[0],
            "issued_operations": issued,
            "plain_ms": t_f32["forward_plain_ms"],
            "library_ms": t_f32["library_forward_ms"],
            "tolerance": FLASH_TOL["float32"]["abs"],
            "max_abs_err": max(unit),
            "max_abs_err_x8": max(e["err"] for e in x8),
            "x8_over_limit": max(e["over"] for e in x8),
            "x8_slack_ulps": FLASH_FWD_SLACK_ULPS,
            "errors": fwd_errs}


def check_flash_backward(torch, dev):
    """Phase 8a: K7-dq and K7-dkv against the plain backward at the
    training shape in f32 and bf16, the shapes of FLASH_BWD_SHAPES and the
    serving shape in bf16 (the plain version chunked); the forward's
    log-sum-exp against the plain one; two runs bit-equal; then times."""
    import torch.nn.functional as F
    from leafgrasp_tpu_torch.kernels.flash_prefill import (
        flash_prefill, flash_prefill_backward, flash_prefill_backward_plain,
        flash_prefill_plain)
    rng = np.random.default_rng(8)
    errs, lse_errs, abs_err = {}, {}, 0.0
    fwd_errs = {}                             # the f32 forward's, per case
    cases = [(n, *case, dt) for n, case in FLASH_BWD_SHAPES.items()
             for dt in (torch.float32, torch.bfloat16)]
    cases.append(("serving", *FLASH_BWD_SERVING, torch.bfloat16))
    kept = {}
    for name, shape, pads, qk_mul, ulps, dtype in cases:
        q, k, v, pad, dout = _flash_bwd_case(torch, dev, dtype, shape, pads,
                                             rng, qk_mul)
        t = shape[1]
        out, lse = flash_prefill(q, k, v, pad, return_lse=True)
        out_plain, lse_plain = flash_prefill_plain(q, k, v, pad, chunk=256,
                                                   return_lse=True)
        if dtype == torch.float32:            # with and without the lse
            fwd_errs[name] = check_f32_forward(torch, name, q, k, v, pad,
                                               out, out_plain, ulps)
        real = torch.isfinite(lse_plain)
        if not torch.equal(real, torch.isfinite(lse)):
            raise RuntimeError(f"phase 8a {name}: lse is finite elsewhere "
                               f"than the plain version's")
        got = flash_prefill_backward(q, k, v, pad, out, lse, dout)
        again = flash_prefill_backward(q, k, v, pad, out, lse, dout)
        want = flash_prefill_backward_plain(q, k, v, pad, out, lse, dout,
                                            chunk=256)
        torch.cuda.synchronize()
        key = f"{name}/{str(dtype).split('.')[1]}"
        lse_err = (lse[real] - lse_plain[real]).abs()
        ulp = 2.0 ** -23 * _score_terms(torch, q, k, t)[real]
        lse_ok = bool((lse_err <= FLASH_LSE_TOL + ulps * ulp).all())
        # the reading: the error beyond FLASH_LSE_TOL in those ulps
        lse_ulps = ((lse_err - FLASH_LSE_TOL).clamp(min=0) / ulp).max().item()
        lse_errs[key] = lse_err.max().item()
        rel = {}
        for gname, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
            if not torch.equal(g, g2):
                raise RuntimeError(f"phase 8a {key} {gname}: two runs "
                                   f"differ")
            zero = not g[:, t:].any() and all(
                not g[i, :p].any() for i, p in enumerate(pads))
            if not (zero and bool(torch.isfinite(g).all())):
                raise RuntimeError(f"phase 8a {key} {gname}: pad rows or "
                                   f"rows beyond t not zero, or not finite")
            rel[gname] = _rel_err(g, w)
            abs_err = max(abs_err, (g - w).abs().max().item())
        errs[key] = rel
        log(f"phase 8a flash backward {key} {shape} pads {pads} q, k x "
            f"{qk_mul}: err / norm {json.dumps(rel)}, lse err "
            f"{lse_errs[key]:.2e} ({lse_ulps:.2f} ulps of the row's terms "
            f"beyond {FLASH_LSE_TOL}, slack {ulps}), bit-equal run to run, "
            f"pad rows zero")
        if max(rel.values()) > FLASH_BWD_REL_TOL or not lse_ok:
            raise RuntimeError(f"phase 8a {key}: err / norm {rel}, lse err "
                               f"{lse_errs[key]} ({lse_ulps} ulps)")
        if name in ("train", "serving"):
            kept[key] = (q, k, v, pad, dout, out, lse)
        del got, again, want
    for name, (shape, pads) in FLASH_FWD_X8.items():
        q, k, v, pad, _ = _flash_bwd_case(torch, dev, torch.float32, shape,
                                          pads, rng, 8.0)
        out, lse = flash_prefill(q, k, v, pad, return_lse=True)
        out_plain, lse_plain = flash_prefill_plain(q, k, v, pad, chunk=256,
                                                   return_lse=True)
        fwd_errs[name] = check_f32_forward(torch, name, q, k, v, pad, out,
                                           out_plain, FLASH_FWD_SLACK_ULPS)
        real = torch.isfinite(lse_plain)
        ulp = 2.0 ** -23 * _score_terms(torch, q, k, shape[1])[real]
        if not (torch.equal(real, torch.isfinite(lse)) and bool(
                ((lse - lse_plain)[real].abs() <= FLASH_LSE_TOL
                 + FLASH_FWD_SLACK_ULPS * ulp).all())):
            raise RuntimeError(f"phase 8a {name}: the f32 forward's "
                               f"log-sum-exp is off the plain one")
        del q, k, v, out, out_plain

    def times(key, iters):
        q, k, v, pad, dout, out, lse = kept[key]
        shape = tuple(q.shape[:3]) + (k.shape[2], q.shape[3])
        pads = pad.tolist()
        bounds = _flash_bwd_bounds(shape, pads, q.dtype)

        def run():
            return flash_prefill_backward(q, k, v, pad, out, lse, dout)
        rep = shape[2] // shape[3]
        ql = q.transpose(1, 2).detach().requires_grad_()
        kl = k[:, :shape[1]].repeat_interleave(rep, dim=2).transpose(1, 2) \
            .detach().requires_grad_()
        vl = v[:, :shape[1]].repeat_interleave(rep, dim=2).transpose(1, 2) \
            .detach().requires_grad_()
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        with torch.no_grad():
            lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True), iters=iters, warmup=1)
        dl = dout.transpose(1, 2)
        res = {"shape": list(shape), "dtype": str(q.dtype).split(".")[1],
               "wrapper_ms": cuda_ms(run, iters=iters, warmup=1),
               "plain_ms": cuda_ms(lambda: flash_prefill_backward_plain(
                   q, k, v, pad, out, lse, dout, chunk=256), iters=1,
                   warmup=1),
               "library_ms": cuda_ms(lambda: torch.autograd.grad(
                   lib_out, (ql, kl, vl), dl, retain_graph=True),
                   iters=iters, warmup=1),
               "library_forward_ms": lib_fwd_ms}
        fwd = "flash_prefill_f32_kernel" if q.dtype == torch.float32 \
            else "flash_prefill_kernel"
        res["forward_plain_ms"] = cuda_ms(lambda: flash_prefill_plain(
            q, k, v, pad, chunk=256), iters=2, warmup=1)
        def median_ms(fn, kernel):
            reps = [kernel_ms(fn, kernel, iters=iters)
                    for _ in range(FLASH_BWD_TIME_REPEATS)]
            return statistics.median(reps), reps
        res["forward_lse_ms"], res["forward_lse_ms_repeats"] = median_ms(
            lambda: flash_prefill(q, k, v, pad, return_lse=True), fwd)
        res["forward_ms"], res["forward_ms_repeats"] = median_ms(
            lambda: flash_prefill(q, k, v, pad), fwd)
        for name in ("dq", "dkv"):
            moved, ops, b_ms, b_by, issued, issued_ms = bounds[name]
            ms, reps = median_ms(run, f"flash_prefill_bwd_{name}_kernel")
            res[name] = {"ms": ms, "ms_repeats": reps,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "issued_bound_ms": issued_ms,
                         "bytes": moved, "operations": ops,
                         "issued_operations": issued,
                         "issued_tflops": issued / ms / 1e9}
        log(f"phase 8a flash backward times {key} {json.dumps(res)}")
        return res

    t_f32 = times("train/float32", 10)
    t_bf16 = times("train/bfloat16", 10)
    t_serv = times("serving/bfloat16", 3)
    records = []
    fwd_train = {"f32_ms": t_f32["forward_ms"],
                 "f32_lse_ms": t_f32["forward_lse_ms"],
                 "f32_library_ms": t_f32["library_forward_ms"],
                 "bf16_ms": t_bf16["forward_ms"],
                 "bf16_lse_ms": t_bf16["forward_lse_ms"],
                 "bf16_library_ms": t_bf16["library_forward_ms"],
                 "bf16_bound_ms": _flash_fwd_bound(t_bf16["shape"], 2)[2],
                 "shape": t_f32["shape"]}
    log(f"phase 8a flash forward at the training shape, without and with "
        f"the log-sum-exp, and SDPA's forward (causal, K/V repeated) "
        f"{json.dumps(fwd_train)}")
    fwd_train["f32"] = f32_forward_record(t_f32, fwd_errs)
    for name, line in (("dkv", 941), ("dq", 1287)):
        rec = {"name": f"flash_prefill_bwd_{name}", "route": "cuda",
               "source": "leafgrasp_tpu_torch/kernels/csrc/"
                         "flash_prefill_bwd.cu",
               "replaces": f"jax/experimental/pallas/ops/tpu/"
                           f"flash_attention.py:{line} (via "
                           f"leafgrasp_tpu/vla/llava_jax.py:314)",
               "tolerance_rel_norm": FLASH_BWD_REL_TOL,
               "max_err_rel_norm": max(max(r.values())
                                       for r in errs.values()),
               "max_abs_err": abs_err,
               "shape": t_f32["shape"], "dtype": "float32",
               "ms": t_f32[name]["ms"], "wrapper_ms": t_f32["wrapper_ms"],
               "plain_ms": t_f32["plain_ms"],
               "bound_ms": t_f32[name]["bound_ms"],
               "bound_by": t_f32[name]["bound_by"],
               "bound_rate": "989 TFLOP/s (bf16 tensor cores) over the "
                             "formulas' products; issued_bound_ms over "
                             "the split's bf16 plane products",
               "issued_bound_ms": t_f32[name]["issued_bound_ms"],
               "library_ms": t_f32["library_ms"],
               "bf16_train": {"ms": t_bf16[name]["ms"],
                              "bound_ms": t_bf16[name]["bound_ms"],
                              "issued_bound_ms":
                                  t_bf16[name]["issued_bound_ms"],
                              "plain_ms": t_bf16["plain_ms"],
                              "library_ms": t_bf16["library_ms"]},
               "bf16_serving": {"shape": t_serv["shape"],
                                "ms": t_serv[name]["ms"],
                                "bound_ms": t_serv[name]["bound_ms"],
                                "issued_bound_ms":
                                    t_serv[name]["issued_bound_ms"],
                                "plain_ms": t_serv["plain_ms"],
                                "library_ms": t_serv["library_ms"]}}
        records.append(rec)
    kept.clear()
    return records, fwd_train


def build_llava_lora(torch, dev):
    """LlavaTorch at the LLaVA-1.6-Mistral-7B widths, single tile
    (CLIP-L/14 at 336: 576 image tokens), base in bf16 drawn on the card
    from seed 0 (``init_random_``), adapters of rank 8 on the seven
    projections of every layer in f32 with Flax's initialization
    (``lora_a`` normal(1 / r), ``lora_b`` 0), the flash prefill."""
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     init_random_)
    from leafgrasp_tpu_torch.vla.lora import LoRADense
    cfg = LlavaTorchConfig(dtype="bfloat16", prefill_attn_impl="flash",
                           lora_rank=8, lora_alpha=32.0, lora_dropout=0.1)
    model = LlavaTorch(cfg, device=dev, param_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    init_random_(model, gen, std=0.02)
    for m in model.modules():
        if isinstance(m, LoRADense) and m.rank > 0:
            m.lora_a = torch.nn.Parameter(torch.empty(
                m.lora_a.shape, device=dev).normal_(
                0.0, 1.0 / cfg.lora_rank, generator=gen))
            m.lora_b = torch.nn.Parameter(torch.zeros(m.lora_b.shape,
                                                      device=dev))
    torch.cuda.synchronize()
    return model


def _adapter_grads(torch, model, trainer, batch):
    from leafgrasp_tpu_torch.vla.trainer import set_trainable
    set_trainable(model, full=False)
    model.zero_grad(set_to_none=True)
    model.train()
    loss = trainer.loss(*batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def profile_llava_step(torch, model, trainer, batch):
    """Device busy time and launches of one LoRA step at full width."""
    from torch.profiler import ProfilerActivity, profile
    from leafgrasp_tpu_torch.vla.trainer import make_adamw, set_trainable
    opt = make_adamw(set_trainable(model, full=False), 0.0)
    model.train()

    def step():
        opt.zero_grad(set_to_none=True)
        trainer.loss(*batch).backward()
        opt.step()
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    lead = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and not ev.is_user_annotation:
            if is_lead_in(ev.name):
                lead += 1
                continue
            rec = by_name.setdefault(ev.name, [0.0, 0])
            rec[0] += ev.self_device_time_total / 1e3
            rec[1] += 1
    kernels = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    flash = {}
    for name, (ms, n) in by_name.items():
        fn = kernel_function(name)
        if fn is not None and fn.startswith("flash_prefill"):
            tot = flash.setdefault(fn, [0.0, 0])
            tot[0] += ms
            tot[1] += n
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "flash_ms_per_launch": {fn: ms / n
                                   for fn, (ms, n) in flash.items()},
           "device_idle_share": 1.0 - busy / wall_ms if busy else None,
           "kernel_launches": sum(k[1] for k in kernels),
           "lead_in_recorded": lead,
           "top": [{"ms": ms, "count": n, "name": name[:90]}
                   for ms, n, name in kernels[:10]]}
    log(f"phase 8b profile of one LoRA step {json.dumps(out)}")
    if not busy:
        raise RuntimeError("phase 8b: the profiled step ran nothing on the "
                           "card")
    model.eval()
    return out


def run_llava_training(torch, dev):
    """Phase 8b and 8c: ``LlavaLoRATrainer`` at full width on the card."""
    import tempfile
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.vla.llava_trainer import LlavaLoRATrainer
    from leafgrasp_tpu_torch.vla.lora import is_lora_key
    from leafgrasp_tpu_torch.vla.trainer import make_synthetic_vla_dataset
    t0 = time.perf_counter()
    model = build_llava_lora(torch, dev)
    cfg = model.cfg
    layers = cfg.layers
    n_lora = sum(p.numel() for n, p in model.named_parameters()
                 if is_lora_key(n))
    n_all = sum(p.numel() for p in model.parameters())
    log(f"phase 8b: LlavaTorch {n_all / 1e9:.3f} G parameters (bf16 base, "
        f"{n_lora / 1e6:.2f} M f32 adapter parameters, rank "
        f"{cfg.lora_rank}), {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        f"GiB allocated, built in {time.perf_counter() - t0:.1f} s")
    tok = ByteStubTok()
    trainer = LlavaLoRATrainer(model, tok, learning_rate=TRAIN_LR,
                               max_len=TRAIN_MAX_LEN, device=None)
    samples = make_synthetic_vla_dataset(
        TRAIN_SCENES, seed=0, num_candidates=TRAIN_CANDIDATES,
        image_size=cfg.image_size)
    examples = trainer.examples(samples)
    pad_to = min(TRAIN_MAX_LEN, max(len(e[0]) for e in examples) + 1)
    order = np.arange(len(examples))
    np.random.default_rng(trainer.seed).shuffle(order)
    first = trainer._pad_batch([examples[i] for i in order[:TRAIN_BATCH]],
                               pad_to)
    t = first[0].shape[1] - 1

    # the first step's gradients on both routes
    reset_launch_counts()
    loss_f, g_flash = _adapter_grads(torch, model, trainer, first)
    flash_counts = launch_counts()
    model.set_prefill_attn("chunked")
    loss_c, g_chunk = _adapter_grads(torch, model, trainer, first)
    model.set_prefill_attn("flash")
    if launch_counts() != flash_counts:
        raise RuntimeError("phase 8b: the chunked route launched the flash "
                           "kernels")
    for name in ("flash_prefill", "flash_prefill_bwd_dq",
                 "flash_prefill_bwd_dkv"):
        if flash_counts[name] != layers:
            raise RuntimeError(f"phase 8b: one flash step launched {name} "
                               f"{flash_counts[name]} times, not {layers}")
    if set(g_flash) != set(g_chunk) or len(g_flash) != 2 * 7 * layers:
        raise RuntimeError(f"phase 8b: {len(g_flash)} adapter gradients on "
                           f"the flash route, {len(g_chunk)} on chunked")
    worst, zero_a = {}, 0
    for name, g in g_flash.items():
        w = g_chunk[name]
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"phase 8b: {name} has no finite gradient")
        if name.endswith(".lora_a"):          # lora_b = 0: exactly zero
            if g.any() or w.any():
                raise RuntimeError(f"phase 8b: {name}'s gradient is not 0")
            zero_a += 1
            continue
        worst[name] = _rel_err(g, w)
    top = sorted(worst.items(), key=lambda kv: -kv[1])
    log(f"phase 8b: step 1 at t = {t}: loss flash {loss_f:.6f} chunked "
        f"{loss_c:.6f}; every adapter gradient finite, lora_a's exactly 0 "
        f"on both routes ({zero_a}); lora_b's largest difference / norm "
        f"{json.dumps(dict(top[:4]))}")
    if top[0][1] > TRAIN_ROUTE_REL_TOL or abs(loss_f - loss_c) > 1e-3:
        raise RuntimeError(f"phase 8b: the routes' gradients differ: "
                           f"{top[:4]}, losses {loss_f} {loss_c}")
    del g_flash, g_chunk

    # the epoch, counts set to 0 just before
    base = {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters() if not is_lora_key(n)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    fit = trainer.fine_tune(samples, epochs=1, batch_size=TRAIN_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = len(examples) // TRAIN_BATCH
    for name in ("flash_prefill", "flash_prefill_bwd_dq",
                 "flash_prefill_bwd_dkv"):
        if counts[name] != layers * steps:
            raise RuntimeError(f"phase 8b: {steps} steps launched {name} "
                               f"{counts[name]} times, not {layers} a step")
    changed = [n for n, p in model.named_parameters()
               if not is_lora_key(n) and not torch.equal(p.detach().cpu(),
                                                         base[n])]
    bad = [n for n, p in model.named_parameters()
           if is_lora_key(n) and not bool(torch.isfinite(p).all())]
    if changed or bad:
        raise RuntimeError(f"phase 8b: frozen leaves changed {changed[:4]}, "
                           f"adapters not finite {bad[:4]}")
    del base
    step_s = wall / steps
    perf = {"steps": steps, "batch": TRAIN_BATCH, "tokens_per_row": t,
            "epoch_s": wall, "step_s": step_s,
            "tokens_per_s": TRAIN_BATCH * t / step_s,
            "peak_memory_gib": peak, "loss_history": fit["loss_history"]}
    log(f"phase 8b: one epoch of {steps} steps {json.dumps(perf)}; the frozen "
        f"base bit-equal, every adapter finite; launches "
        f"{json.dumps(counts)}")

    # the adapter saved and reloaded
    work = tempfile.mkdtemp(dir="build")
    path = os.path.join(work, "adapter.npz")
    trainer.save_adapter(path)
    ids = first[0][:, :-1]
    with torch.no_grad():
        want = model(ids, pixel_values=first[2])[0]
        for n, p in model.named_parameters():
            if is_lora_key(n):
                p.zero_()
        trainer.load_adapter(path)
        got = model(ids, pixel_values=first[2])[0]
    diff = (got - want).abs().max().item()
    if diff > ADAPTER_RELOAD_TOL:
        raise RuntimeError(f"phase 8b: logits after reloading the adapter "
                           f"differ by {diff}")
    log(f"phase 8b: adapter {path} saved and reloaded: logits equal "
        f"(largest difference {diff})")
    del want, got

    perf["profile"] = profile_llava_step(torch, model, trainer, first)

    # five steps on one batch: from the second on the loss falls
    few = LlavaLoRATrainer(model, tok, learning_rate=OVERFIT_LR,
                           max_len=TRAIN_MAX_LEN, device=None)
    one = [dict(samples[0], candidates=samples[0]["candidates"][:2],
                ranking=[0, 1])]
    fit5 = few.fine_tune(one, epochs=OVERFIT_STEPS, batch_size=2)
    hist = fit5["loss_history"]
    log(f"phase 8b: {OVERFIT_STEPS} steps on one batch at lr {OVERFIT_LR}: "
        f"loss {hist}")
    if not (hist[-1] < hist[0]
            and all(b < a for a, b in zip(hist[1:], hist[2:]))):
        raise RuntimeError(f"phase 8b: the loss did not fall: {hist}")
    perf["overfit_loss"] = hist

    # 8c: the model as phase 6 holds it, adapters in bf16 too
    for m in model.modules():
        if getattr(m, "rank", 0) > 0:
            m.lora_a = torch.nn.Parameter(m.lora_a.detach().bfloat16())
            m.lora_b = torch.nn.Parameter(m.lora_b.detach().bfloat16())
    bf = LlavaLoRATrainer(model, tok, learning_rate=TRAIN_LR,
                          max_len=TRAIN_MAX_LEN, device=None)
    torch.cuda.synchronize()
    reset_launch_counts()
    fit_bf = bf.fine_tune(one, epochs=1, batch_size=2)
    torch.cuda.synchronize()
    counts_bf = launch_counts()
    ok = np.isfinite(fit_bf["final_loss"]) and all(
        bool(torch.isfinite(p).all()) for n, p in model.named_parameters()
        if is_lora_key(n))
    if not ok or any(counts_bf[k] != layers for k in (
            "flash_prefill", "flash_prefill_bwd_dq",
            "flash_prefill_bwd_dkv")):
        raise RuntimeError(f"phase 8c: bf16 step loss {fit_bf}, launches "
                           f"{counts_bf}")
    log(f"phase 8c: one step with bf16 adapters: loss "
        f"{fit_bf['final_loss']:.5f}, launches {json.dumps(counts_bf)}")
    del model, trainer, few, bf
    return counts, counts_bf, perf


def run_phase_8(torch, dev):
    """Phase 8: the flash prefill's backward kernels, then the LLaVA LoRA
    trainer at full width."""
    records, fwd_train = check_flash_backward(torch, dev)
    log("phase 8a: the flash prefill's backward kernels match their plain "
        "version")
    counts, counts_bf16, perf = run_llava_training(torch, dev)
    # each kernel's time a launch inside the profiled LoRA step
    per_launch = perf["profile"]["flash_ms_per_launch"]
    for rec in records:
        rec["in_step_ms"] = per_launch[f"{rec['name']}_kernel"]
    fwd_train["in_step_f32_lse_ms"] = per_launch["flash_prefill_f32_kernel"]
    return records, fwd_train, counts, counts_bf16, perf


# ---------------------------------------------------------------- phase 9 --
# the full-width checkpoint of phase 9a: the 7B widths (CLIP-L/336 tower,
# Mistral 4096 / 14336, 32 over 8 heads, vocab 32064, the five anyres
# pinpoints) cut to 2 decoder and 2 vision layers, bf16, in 3 shards (the
# JAX package's real-dims checkpoint test), about 1.5 GB
CKPT_DIR = os.path.join("build", "chip_smoke_ckpt")
CKPT_LAYERS = 2
CKPT_VIS_LAYERS = 2
CKPT_SHARDS = 3
CKPT_SEED = 0
QUANT_MODES = {"bf16": ("none", 8), "int8": ("int8", 8),
               "int4": ("int4", 4)}
QUANT_GROUP = 128
SERVE_NEW_TOKENS = 4
# QuantDense on the card at a decode shape (the rerank's five rows) and the
# prompt pass's (5 x 2400 rows), on gate_proj's widths (4096 -> 14336),
# bf16 compute. int8 and int4's per-group partials round once: against
# the f64 product on the card (quant_dense_exact) each output is within
# half a bf16 ulp of the value plus 2^-12 of its row's rms
# (one_rounding_share <= 1), and int8's bf16 product rounded before the
# scale must miss that limit. int4's prompt-pass formulation rounds the
# dequantized weight to bf16 before its product: |layer - plain| <=
# QUANT_DENSE_TOL * (|plain| + the row's largest |plain|), two ulps
QUANT_ROWS = {"decode": 5, "prefill": 12000}
# allocator slack of phase 9b's peak bound (scales, block rounding)
QUANT_PEAK_SLACK = 64 * 2 ** 20
QUANT_DENSE_TOL = 2.0 ** -6


def _counts_sum(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def write_phase9_checkpoint():
    """Phase 9a's checkpoint, written by the port's own writers."""
    import shutil
    from leafgrasp_tpu_torch.vla.checkpoint_io import \
        write_synthetic_llava_checkpoint
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorchConfig
    cfg = LlavaTorchConfig(layers=CKPT_LAYERS, vis_layers=CKPT_VIS_LAYERS,
                           image_grid_pinpoints=VLA_PINPOINTS)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    n_bytes = write_synthetic_llava_checkpoint(
        CKPT_DIR, cfg, seed=CKPT_SEED, n_shards=CKPT_SHARDS)
    log(f"phase 9a: wrote a {CKPT_SHARDS}-shard checkpoint at the 7B widths "
        f"({CKPT_LAYERS} decoder, {CKPT_VIS_LAYERS} vision layers) under "
        f"{CKPT_DIR}: {n_bytes} bytes of safetensors in "
        f"{time.perf_counter() - t0:.1f} s")
    return n_bytes


def check_loaded_state(torch, mode, bits, state, written, rename):
    """The loaded state on the card against the checkpoint's tensors: bf16
    bit-equal; the quantized codes and scales bit-equal to the port's
    host quantizer on the same bf16 tensors (every weight in bf16, the
    largest ones in int8 and int4 too)."""
    from leafgrasp_tpu_torch.vla.quant import (is_quantized_weight,
                                               quantize_kernel)
    n_q = 0
    for src, dst in rename.items():
        host = written[src]
        if mode == "bf16" or not is_quantized_weight(dst):
            if not torch.equal(state[dst].cpu().view(torch.int16),
                               host.view(torch.int16)):
                raise RuntimeError(f"phase 9a {mode}: {dst} differs from "
                                   f"the checkpoint")
            continue
        stem = dst[:-len("weight")]
        q, s = quantize_kernel(host.T, bits, QUANT_GROUP)
        if not (torch.equal(state[stem + "kernel_q"].cpu(), q)
                and torch.equal(state[stem + "kernel_scale"].cpu(), s)):
            raise RuntimeError(f"phase 9a {mode}: {stem}kernel_q / "
                               f"kernel_scale differ from the host "
                               f"quantizer's")
        n_q += 1
    return n_q


def run_phase_9a(torch, dev, n_bytes):
    """Phase 9a: the full-width checkpoint loaded onto the card in bf16,
    int8 and int4, checked against what was written, and served once per
    mode through tools/serve_llava_torch.py's main."""
    import contextlib
    import io
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.vla.checkpoint_io import (_hf_name_map,
                                                       _read_state_dict,
                                                       load_llava_checkpoint)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import serve_llava_torch

    written = _read_state_dict(CKPT_DIR)
    out = {"bytes_on_disk": n_bytes}
    counts = {}
    for mode, (flag, bits) in QUANT_MODES.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model, state, _ = load_llava_checkpoint(
            CKPT_DIR, dtype="bfloat16", quantize=flag != "none",
            quant_bits=bits, quant_group=QUANT_GROUP, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        resident = torch.cuda.memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        n_q = check_loaded_state(torch, mode, bits, state, written,
                                 _hf_name_map(model.cfg, written))
        check_s = time.perf_counter() - t0
        del model, state
        torch.cuda.empty_cache()

        argv = [CKPT_DIR, "--dtype", "bfloat16", "--quantize", flag,
                "--quant-group", str(QUANT_GROUP), "--anyres",
                "--max-new-tokens", str(SERVE_NEW_TOKENS), "--json"]
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve_llava_torch.main(argv)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        cnt = launch_counts()
        counts = _counts_sum(counts, cnt)
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        # the selector falls back to geometry if the scorer raises: its
        # own record proves the rerank ran to its end (scores are set
        # only when it returns; every candidate decoded its tokens)
        n = len(res["candidates"])
        if (cnt["flash_prefill"] != CKPT_LAYERS * (2 if n > 1 else 1)
                or not n
                or res["best"] is None or res["vla_scores"] is None
                or len(res["vla_scores"]) != n
                or res["generated_tokens"] != [SERVE_NEW_TOKENS] * n
                or not res["prefill_ms"] > 0 or not res["decode_ms"] > 0):
            raise RuntimeError(f"phase 9a {mode}: served {res}, flash "
                               f"launches {cnt['flash_prefill']}")
        out[mode] = {"load_s": load_s, "resident_gib": resident / 2 ** 30,
                     "load_peak_gib": peak / 2 ** 30, "check_s": check_s,
                     "quantized_weights_checked": n_q, "serve_s": serve_s,
                     "rerank_s": res["rerank_s"],
                     "vla_scores": res["vla_scores"],
                     "prefill_ms": res["prefill_ms"],
                     "decode_ms": res["decode_ms"],
                     "best_leaf": res["best"]["leaf_id"],
                     "strategy": res["best"]["strategy"],
                     "flash_launches": cnt["flash_prefill"]}
        log(f"phase 9a {mode}: {json.dumps(out[mode])}")
    del written
    return out, counts


def _quant_dense_err(name, lay, x, got):
    """(largest |got - reference|, largest share of its limit): int8 and
    int4's partials against the f64 product, held to one rounding;
    int4's dequantized product against the plain version, at
    QUANT_DENSE_TOL."""
    from leafgrasp_tpu_torch.vla.quant import (one_rounding_share,
                                               quant_dense_exact,
                                               quant_dense_plain)
    if name == "int4_dequant":
        w = quant_dense_plain(lay, x).float()
        d = (got.float() - w).abs()
        lim = QUANT_DENSE_TOL * (w.abs() + w.abs().amax(dim=-1, keepdim=True))
        return float(d.max()), float((d / lim.clamp_min(1e-30)).max())
    exact = quant_dense_exact(lay, x)
    return (float((got.double() - exact).abs().max()),
            one_rounding_share(got, exact))


def check_quant_dense(torch, dev, qmodel):
    """QuantDense on the card against its references at the decode and
    prompt-pass shapes: int8 (the served model's layer 0 gate_proj), int4
    by per-group partials and by the dequantized product; int8's product
    rounded to bf16 before its scale must fail the one-rounding check;
    beside each, the weight conversion that eager torch materializes."""
    from leafgrasp_tpu_torch.vla.quant import (QuantDense, one_rounding_share,
                                               quant_dense_exact,
                                               quant_dense_plain,
                                               quantize_kernel)
    int8 = qmodel.layers[0].gate_proj
    n_in, n_out = int8.in_features, int8.features
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    w = 0.02 * torch.randn((n_in, n_out), generator=gen, device=dev)
    layers = {"int8": int8}
    for name, thr in (("int4_partials", 10 ** 9), ("int4_dequant", 0)):
        lay = QuantDense(n_in, n_out, dtype=torch.bfloat16, bits=4,
                         group=QUANT_GROUP, dequant_threshold=thr,
                         device=dev)
        q, s = quantize_kernel(w, 4, QUANT_GROUP)
        with torch.no_grad():
            lay.kernel_q.copy_(q)
            lay.kernel_scale.copy_(s)
        layers[name] = lay
    del w
    out = {}
    with torch.no_grad():
        for shape, rows in QUANT_ROWS.items():
            x = torch.randn((rows, n_in), generator=gen, device=dev) \
                .to(torch.bfloat16)
            for name, lay in layers.items():
                if name == "int4_partials" and shape == "prefill":
                    # the (rows, 32 groups, 14336) f32 partials would take
                    # 2 x 22 GB: the layer dequantizes above 256 rows
                    continue
                err, share = _quant_dense_err(name, lay, x, lay(x))
                rec = {"rows": rows, "max_abs_err": err,
                       "share_of_tol": share}
                if name == "int8":
                    twice = (torch.mm(x, lay.kernel_q.to(torch.bfloat16))
                             .float() * lay.kernel_scale).to(torch.bfloat16)
                    rec["bf16_product_share"] = one_rounding_share(
                        twice, quant_dense_exact(lay, x))
                    del twice
                    if rec["bf16_product_share"] <= 1.0:
                        raise RuntimeError(
                            f"phase 9b: the one-rounding check of int8 at "
                            f"{rows} rows does not tell a bf16 product "
                            f"rounded before its scale apart ({rec})")
                if share > 1.0:
                    raise RuntimeError(
                        f"phase 9b: QuantDense {name} at {rows} rows is "
                        f"{err} from its reference ({share} of the limit)")
                rec["ms"] = cuda_ms(lambda: lay(x), iters=10)
                rec["plain_ms"] = cuda_ms(
                    lambda: quant_dense_plain(lay, x), iters=5)
                out[f"{name}_{shape}"] = rec
            del x
        # what eager torch materializes beside each product: the int8
        # codes in bf16, int4's dequantized bf16 weight
        conv = {"int8_to_bf16": (lambda: int8.kernel_q.to(torch.bfloat16),
                                 n_in * n_out * 3),
                "int4_dequantize": (layers["int4_dequant"].dequantized,
                                    n_in * n_out // 2 + n_in * n_out * 2
                                    + 4 * n_in // QUANT_GROUP * n_out)}
        for name, (fn, n_bytes) in conv.items():
            ms = cuda_ms(fn, iters=20)
            out[name] = {"ms": ms, "bytes": n_bytes,
                         "bound_ms": n_bytes / PEAK_BYTES_PER_S * 1e3}
    for key, val in out.items():
        log(f"phase 9b QuantDense {key} {json.dumps(val)}")
    return out


def run_phase_9b(torch, dev, bf16_perf):
    """Phase 9b: the 7B model at full width and depth quantized to int8 on
    the card (the bf16 state consumed), then served."""
    import dataclasses
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorch
    from leafgrasp_tpu_torch.vla.quant import quantize_llava_state_device

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_llava(torch, dev)
    cfg = model.cfg
    layers = cfg.layers
    torch.cuda.synchronize()
    bf16_bytes = torch.cuda.memory_allocated() - base
    largest = max(p.numel() for n, p in model.named_parameters()
                  if n.endswith("proj.weight") or n == "lm_head.weight")
    state = model.state_dict()
    del model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    box = [state]
    del state
    qstate = quantize_llava_state_device(box)
    qmodel = LlavaTorch.from_state(dataclasses.replace(cfg, quantized=True),
                                   qstate)
    del qstate
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    int8_bytes = sum(p.numel() * p.element_size()
                     for p in qmodel.parameters())
    # the bf16 model and one kernel's quantization (its f32 copy and up to
    # three f32 intermediates), and QUANT_PEAK_SLACK for the allocator:
    # the int8 tree grows only as the bf16 weights it replaces are freed,
    # so a quantizer that held both models (about 21 GiB) would fail
    peak_bound = bf16_bytes + 16 * largest + QUANT_PEAK_SLACK
    log(f"phase 9b: int8 in {quant_s:.2f} s; resident "
        f"{resident / 2 ** 30:.2f} GiB (bf16 {bf16_bytes / 2 ** 30:.2f} "
        f"GiB, int8 tree {int8_bytes / 2 ** 30:.2f} GiB); peak "
        f"{peak / 2 ** 30:.2f} GiB (bound {peak_bound / 2 ** 30:.2f} GiB: "
        f"bf16 model + one kernel's f32 working set)")
    if peak > peak_bound:
        raise RuntimeError("phase 9b: the device quantizer held more than "
                           "the bf16 model and one kernel")

    scorer = LlavaTorchScorer(qmodel, FixedLenTok(cfg.vocab_size),
                              max_new_tokens=10, decode_mode="steps",
                              anyres=True)
    rgb = (np.random.default_rng(0).uniform(0, 255, (H, W, 3))
           .astype(np.uint8))
    rng = np.random.default_rng(3)
    cands = [dict(leaf_id=i + 1, x=float(rng.uniform(100, W - 100)),
                  y=float(rng.uniform(100, H - 100)),
                  clutter_score=float(rng.uniform(0.2, 1.0)),
                  distance_score=float(rng.uniform(0.2, 1.0)),
                  visibility_score=float(rng.uniform(0.2, 1.0)),
                  geometric_score=float(rng.uniform(0.2, 1.0)))
             for i in range(5)]
    instruction = "Select the best leaf for grasping"
    scorer.score(rgb, cands, instruction)              # warm-up, uncounted
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scores = scorer.score(rgb, cands, instruction)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    rerank_peak = torch.cuda.max_memory_allocated() - base
    last = dict(scorer.last)
    tokens = last.pop("tokens")
    if not (len(scores) == 5 and np.isfinite(scores).all()) \
            or counts["flash_prefill"] != 2 * layers:
        raise RuntimeError(f"phase 9b: scores {scores}, flash launches "
                           f"{counts['flash_prefill']}")
    prof = profile_rerank(torch, scorer, rgb, cands, instruction, "phase 9b")
    scorer.max_batch = 1
    scorer.score(rgb, cands, instruction)
    single = scorer.last["tokens"]
    scorer.max_batch = None
    kept = int((np.asarray(tokens) == np.asarray(single)).sum())
    perf = {"resident_gib": resident / 2 ** 30,
            "bf16_gib": bf16_bytes / 2 ** 30, "peak_gib": peak / 2 ** 30,
            "quantize_s": quant_s, "rerank_wall_ms": wall_ms,
            "encode_ms": last.get("encode_ms"),
            "prefill_ms": last["prefill_ms"], "decode_ms": last["decode_ms"],
            "decode_step_device_ms": prof["decode_step_device_ms"],
            "decode_step_launches": prof["decode_step_launches"],
            "rerank_peak_gib": rerank_peak / 2 ** 30,
            "tokens_kept_batched_vs_single": kept,
            "tokens": int(np.asarray(tokens).size),
            "bf16_phase6": bf16_perf}
    log(f"phase 9b int8 rerank: scores {scores}; t {last['prompt_len']}; "
        f"{json.dumps(perf)}")
    log(f"phase 9b: int8 keeps {kept} of {perf['tokens']} greedy tokens "
        f"between the batched and the one-by-one rerank (bf16, phase 6.2: "
        f"{perf['tokens'] - bf16_perf['batched_vs_single_tokens_differ']} "
        f"of 50)")
    perf["quant_dense"] = check_quant_dense(torch, dev, qmodel)
    del qmodel, scorer
    torch.cuda.empty_cache()
    return counts, perf


def run_phase_9(torch, dev, bf16_perf):
    """Phase 9: serving from a checkpoint on disk, bf16, int8 and int4."""
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"phase 9: {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB of "
        f"device memory free, {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated")
    t0 = time.perf_counter()
    n_bytes = write_phase9_checkpoint()
    ckpt, counts_a = run_phase_9a(torch, dev, n_bytes)
    counts_b, perf = run_phase_9b(torch, dev, bf16_perf)
    perf["checkpoint"] = ckpt
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return counts_a, counts_b, perf



# --------------------------------------------------------------- phase 10 --
PAR_MODES = ("union", "reference_self")
PAR_WORLDS = {1: "nccl", 2: "gloo", 4: "gloo"}
PAR_TIME_REPEATS = 5
PAR_BATCH = 4
PAR_TRAIN_SAMPLES = 256
PAR_TRAIN_EPOCHS = 2
PAR_TRAIN_MESHES = {2: (2, 1), 4: (2, 2)}
PAR_SERVICE_WORLD = 2
PAR_SERVICE_FRAMES = 8
PAR_XYZ_TOL = 1e-6
PAR_COMBINED_REL_TOL = 1e-4
# one train step on the mesh against the single-process step on the same
# global batch: loss and BatchNorm statistics relative, each gradient
# against its tensor's norm (a BatchNorm-fed bias, whose exact gradient
# is 0, against its layer's weight gradient); phase 7c's bound for the
# card's step against the CPU's, another order of the same sums (cuDNN
# picks other algorithms for a rank's half batch; read: 1.24e-5 on an
# NVIDIA H100 80GB HBM3 at 700 W)
PAR_STEP_REL_TOL = TRAIN_GRAD_REL_TOL
PAR_STEP_BATCH = 16
# The 2-epoch fit is not held to the single-process fit's losses: Adam's
# early steps normalise each gradient, so the rounding noise of a
# near-zero gradient becomes a step of the learning rate, and a fit
# whose sums run in another order (here: over shards) parts from the
# single-process fit by far more than its rounding; the single-process
# fit parts from itself the same way when only the order of its sums
# changes. The run prints both fits' losses, and the single-process
# fit's against itself with cuDNN's algorithms chosen by timing.
PAR_RANK_TIMEOUT_S = 120.0
PAR_JOIN_S = 420.0
PAR_KERNELS = ("fused_score_maps", "minplus_pass2", "fused_attention_gate",
               "attention_gate_backward")


def _par_service_frames(mask, depth):
    return [(np.roll(mask, 3 * i, axis=1), np.roll(depth, 3 * i, axis=1))
            for i in range(PAR_SERVICE_FRAMES)]


def _par_setup(device: str = "cuda") -> dict:
    """What a phase-10 rank needs of this script's settings (a spawned
    rank imports the script anew)."""
    return {"device": device, "h": H, "w": W, "cam": (CX, CY, F),
            "families": FAMILIES, "train_samples": PAR_TRAIN_SAMPLES}


def _par_cut_n(n):
    """The first ``n`` samples of the training corpus."""
    return {k: v[:n] for k, v in _corpus().items()}


def phase10_rank(rank, world, setup):
    """One rank of phase 10 on ``cuda:0`` (or the CPU, to rehearse): the
    sharded frame (10a), the batched frame (10b), the mesh fit (10c) and
    the sharded service (10d), as ``world`` asks; returns the results on
    the host and the rank's launch counts."""
    import torch
    dev = setup["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()
    h, w = setup["h"], setup["w"]
    cx, cy, f = setup["cam"]
    from leafgrasp_tpu_torch.config import (DEFAULT_CONFIG, FrameConfig,
                                            GraspScoringConfig, ModelConfig,
                                            TrainConfig)
    from leafgrasp_tpu_torch.io.scenes import (default_projection,
                                               make_leaf_scene)
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.kernels.build import load_library
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      init_random_)
    from leafgrasp_tpu_torch.parallel import (make_batched_frame_fn,
                                              make_mesh,
                                              make_sharded_frame_fn)
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    from leafgrasp_tpu_torch.training import Trainer
    from leafgrasp_tpu_torch.utils.device import fetch_to_host

    if dev == "cuda":
        load_library()
    scenes = {name: make_leaf_scene(h, w, num_leaves=n, seed=seed,
                                    margin=margin)
              for name, n, seed, margin in setup["families"]}
    cnn = init_random_(GraspPointCNN(ModelConfig()), seed=0).to(dev).eval()
    cfgs = {mode: DEFAULT_CONFIG.replace(
        frame=FrameConfig(height=h, width=w),
        grasp=GraspScoringConfig(isolation_context=mode))
        for mode in PAR_MODES}
    mesh = make_mesh(world, device=dev)
    out = {"frames": {}, "calls": {}}
    sync()
    reset_launch_counts()

    # 10a: the row-sharded frame
    for mode in PAR_MODES:
        fn = make_sharded_frame_fn(mesh, cfgs[mode], with_cnn=True)
        for name in scenes:
            fn.axis.reset_counts()
            out["frames"][(mode, name)] = fetch_to_host(
                fn(*scenes[name], cx, cy, f, cnn))
            out["calls"][(mode, name)] = (fn.axis.calls, fn.axis.bytes)
    times = []
    for _ in range(PAR_TIME_REPEATS):
        sync()
        t0 = time.perf_counter()
        fn(*scenes["sparse"], cx, cy, f, cnn)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    out["frame_ms"] = times

    # 10b: the data-parallel batched frame
    if world <= 2:
        mask, depth = scenes["sparse"]
        frames = _par_service_frames(mask, depth)[:PAR_BATCH]
        bfn = make_batched_frame_fn(mesh, cfgs["union"], with_cnn=True)
        out["batched"] = fetch_to_host(bfn(
            np.stack([m for m, _ in frames]),
            np.stack([d for _, d in frames]), cx, cy, f, cnn))

    # 10c: the data- (and tensor-) parallel step and fit
    if world in PAR_TRAIN_MESHES:
        data, model_axis = PAR_TRAIN_MESHES[world]
        fit_mesh = make_mesh(world, model_axis=model_axis, device=dev)
        out["step"] = _par_step(torch, dev, fit_mesh)
        ends = []
        t0 = time.perf_counter()

        def log_epoch(**_):
            sync()
            ends.append(time.perf_counter())
        res = Trainer(ModelConfig(), TrainConfig(seed=TRAIN_SEED),
                      mesh=fit_mesh).fit(_par_cut_n(setup["train_samples"]),
                                         epochs=PAR_TRAIN_EPOCHS,
                                         log_fn=log_epoch)
        out["fit"] = {"train_loss": res.history["train_loss"],
                      "weights_digest": float(sum(
                          v.double().sum() for v in
                          res.model.state_dict().values()
                          if v.dtype.is_floating_point)),
                      "val_loss": res.history["val_loss"],
                      "epoch_s": [b - a for a, b in zip([t0] + ends[:-1],
                                                        ends)]}

    # 10d: the service over a row-sharded frame
    if world == PAR_SERVICE_WORLD:
        msgs, seen = [], []
        svc = GraspService(cfgs["union"], cnn=cnn, publish=msgs.append,
                           on_result=seen.append, min_interval_s=0.0,
                           spatial_mesh=mesh)
        svc.set_camera_params(default_projection())
        for mask, depth in _par_service_frames(*scenes["sparse"]):
            svc.process_frame(mask, depth)
        out["service"] = {"published": msgs, "on_result": len(seen)}
    sync()
    out["launches"] = launch_counts()
    return out


def _par_step_batch(torch, dev):
    """The first PAR_STEP_BATCH corpus samples as NHWC features."""
    cut = _par_cut_n(PAR_STEP_BATCH)
    feats = np.concatenate([cut["depth_patches"][..., None],
                            cut["mask_patches"][..., None],
                            np.moveaxis(cut["score_patches"], 1, -1)], -1)
    return (torch.as_tensor(feats, dtype=torch.float32, device=dev),
            torch.as_tensor(cut["labels"], dtype=torch.float32, device=dev))


def _par_step(torch, dev, mesh=None):
    """One seeded train step of the standard CNN (``init_random_`` seed 0)
    on the corpus batch: on ``mesh`` (this rank's rows, the gradients of
    sharded tensors gathered) or, without one, the single-process step.
    Returns (loss, {name: grad}, {name: BatchNorm running stat}) on the
    host."""
    from leafgrasp_tpu_torch.config import ModelConfig, TrainConfig
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      init_random_)
    from leafgrasp_tpu_torch.parallel.collectives import Axis
    from leafgrasp_tpu_torch.training.train import (
        make_optimizer, make_parallel_train_step, make_train_step,
        parallelize_grasp_cnn)
    tcfg = TrainConfig(seed=TRAIN_SEED, batch_size=PAR_STEP_BATCH)
    model = init_random_(GraspPointCNN(ModelConfig()), seed=0).to(dev)
    rows, sharded = slice(0, PAR_STEP_BATCH), set()
    if mesh is None:
        step = make_train_step(model, make_optimizer(model, tcfg), tcfg)
    else:
        model, sharded, rows = parallelize_grasp_cnn(model, mesh,
                                                     PAR_STEP_BATCH)
        step = make_parallel_train_step(model, make_optimizer(model, tcfg),
                                        tcfg, mesh, sharded)
    feats, labels = _par_step_batch(torch, dev)
    torch.manual_seed(TRAIN_SEED)
    loss, _ = step(feats[rows], labels[rows],
                   torch.ones(rows.stop - rows.start, device=dev),
                   float(tcfg.pos_weight))
    grads = {n: p.grad for n, p in model.named_parameters()}
    if sharded:
        tp = Axis(mesh, "model")
        grads = {n: torch.cat(list(tp.gather(g))) if n in sharded else g
                 for n, g in grads.items()}
    return (float(loss), {n: g.cpu().numpy() for n, g in grads.items()},
            {n: b.cpu().numpy() for n, b in model.named_buffers()
             if "running" in n})


def _par_check_step(tag, got, want):
    """A mesh step against the single-process step (PAR_STEP_REL_TOL)."""
    from leafgrasp_tpu_torch.config import ModelConfig
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      batchnorm_fed_biases)
    bn_fed = batchnorm_fed_biases(GraspPointCNN(ModelConfig()))
    errs = {"loss": abs(got[0] - want[0]) / abs(want[0])}
    for name, g in want[1].items():
        scale = np.linalg.norm(want[1][name[:-len("bias")] + "weight"]) \
            if name in bn_fed else np.linalg.norm(g)
        errs[name] = float(np.linalg.norm(got[1][name] - g)
                           / max(scale, 1e-30))
    for name, b in want[2].items():
        errs[name] = float(np.abs(got[2][name] - b).max()
                           / max(np.abs(b).max(), 1e-30))
    worst = max(errs, key=errs.get)
    if errs[worst] > PAR_STEP_REL_TOL:
        raise RuntimeError(f"{tag}: one step differs from the "
                           f"single-process step by {errs[worst]:.2e} "
                           f"({worst})")
    return errs[worst], worst


def _par_check_frame(tag, got, want):
    """A sharded or batched frame against ``make_frame_fn``'s."""
    if int(got.leaf_id) != int(want.leaf_id) \
            or not np.array_equal(got.grasp_uv, want.grasp_uv) \
            or bool(got.ml_used) != bool(want.ml_used) \
            or not np.array_equal(got.candidates.x, want.candidates.x) \
            or not np.array_equal(got.candidates.y, want.candidates.y):
        raise RuntimeError(f"{tag}: leaf {int(got.leaf_id)} pixel "
                           f"{got.grasp_uv} ml {bool(got.ml_used)} != "
                           f"{int(want.leaf_id)} {want.grasp_uv} "
                           f"{bool(want.ml_used)}")
    xyz = max(float(np.abs(got.grasp_xyz - want.grasp_xyz).max()),
              float(np.abs(got.pre_grasp_xyz - want.pre_grasp_xyz).max()))
    comb = float(np.abs(got.fusion.combined - want.fusion.combined).max()
                 / max(np.abs(want.fusion.combined).max(), 1e-30))
    if xyz > PAR_XYZ_TOL or comb > PAR_COMBINED_REL_TOL:
        raise RuntimeError(f"{tag}: 3D points differ by {xyz}, fused "
                           f"scores by {comb} relative")
    return xyz, comb


def run_phase_10(torch, results, cfgs, model, setup=None):
    """Phase 10: the parallel layer on 1, 2 and 4 ranks of one card
    (``setup``: ``_par_setup``'s, on the card by default)."""
    setup = setup or _par_setup()
    dev = setup["device"]

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()
    from leafgrasp_tpu_torch.config import ModelConfig, TrainConfig
    from leafgrasp_tpu_torch.io.scenes import (default_projection,
                                               make_leaf_scene)
    from leafgrasp_tpu_torch.parallel.launch import run_ranks
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    from leafgrasp_tpu_torch.training import Trainer
    from leafgrasp_tpu_torch.utils.device import fetch_to_host

    t_start = time.perf_counter()
    want = {key: fetch_to_host(res) for key, res in results.items()
            if key[0] in PAR_MODES}
    _, n, seed, margin = setup["families"][0]
    mask, depth = make_leaf_scene(setup["h"], setup["w"], num_leaves=n,
                                  seed=seed, margin=margin)
    frames = _par_service_frames(mask, depth)
    single = make_frame_fn(cfgs["union"], with_cnn=True, device=dev)
    want_batch = [fetch_to_host(single(m, d, *setup["cam"], model))
                  for m, d in frames[:PAR_BATCH]]
    msgs = []
    svc = GraspService(cfgs["union"], cnn=model, publish=msgs.append,
                       min_interval_s=0.0, device=dev)
    svc.set_camera_params(default_projection())
    for m, d in frames:
        svc.process_frame(m, d)
    ends = []
    t0 = time.perf_counter()

    def log_epoch(**_):
        sync()
        ends.append(time.perf_counter())
    ref_fit = Trainer(ModelConfig(), TrainConfig(seed=TRAIN_SEED),
                      device=dev).fit(_par_cut_n(setup["train_samples"]),
                                      epochs=PAR_TRAIN_EPOCHS,
                                      log_fn=log_epoch)
    ref_epoch_s = [b - a for a, b in zip([t0] + ends[:-1], ends)]
    ref_step = _par_step(torch, dev)
    # the same fit with cuDNN choosing its algorithms by timing: the
    # same arithmetic, other orders of its sums
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        alt_fit = Trainer(ModelConfig(), TrainConfig(seed=TRAIN_SEED),
                          device=dev).fit(
            _par_cut_n(setup["train_samples"]), epochs=PAR_TRAIN_EPOCHS)
    finally:
        torch.backends.cudnn.benchmark = bench
    self_rel = [abs(a - b) / abs(b) for a, b in zip(
        alt_fit.history["train_loss"], ref_fit.history["train_loss"])]
    log(f"phase 10c: the single-process fit against itself with cuDNN's "
        f"algorithms chosen by timing: train loss "
        f"{ref_fit.history['train_loss']} and "
        f"{alt_fit.history['train_loss']} (relative {self_rel})")
    log(f"phase 10: references on the card in "
        f"{time.perf_counter() - t_start:.1f} s (single-process fit "
        f"{ref_epoch_s} s an epoch)")

    store = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_par_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    launches, perf = {}, {"frame_ms": {}, "collectives": {}}
    for world, backend in PAR_WORLDS.items():
        if dev == "cpu":
            backend = "gloo"
        t0 = time.perf_counter()
        outs = run_ranks(phase10_rank, world, store, setup, backend=backend,
                         timeout_s=PAR_RANK_TIMEOUT_S, join_s=PAR_JOIN_S,
                         threads=2)
        spawn_s = time.perf_counter() - t0
        errs = []
        for rank, out in enumerate(outs):
            for name, n in out["launches"].items():
                launches[name] = launches.get(name, 0) + n
            for key, got in out["frames"].items():
                errs.append(_par_check_frame(
                    f"phase 10a {world} ranks, rank {rank} {key}", got,
                    want[key]))
            if "batched" in out:
                for i, w in enumerate(want_batch):
                    got = type(w)(*[_par_index(x, i) for x in
                                    out["batched"]])
                    errs.append(_par_check_frame(
                        f"phase 10b {world} ranks, rank {rank} frame {i}",
                        got, w))
            if "step" in out:
                step_err, step_worst = _par_check_step(
                    f"phase 10c {world} ranks, rank {rank}", out["step"],
                    ref_step)
                _par_check_fit(world, rank, out["fit"], outs[0]["fit"])
            if "service" in out:
                want_pub = msgs if rank == 0 else []
                got_pub = out["service"]["published"]
                if len(got_pub) != len(want_pub) or not all(
                        _same_message(a, b, SERVICE_FLOAT_TOL)
                        for a, b in zip(got_pub, want_pub)) \
                        or out["service"]["on_result"] != len(want_pub):
                    raise RuntimeError(f"phase 10d rank {rank}: published "
                                       f"{got_pub}, want {want_pub}")
        perf["frame_ms"][world] = statistics.median(outs[0]["frame_ms"])
        perf["collectives"][world] = {f"{m}/{n}": c for (m, n), c
                                      in outs[0]["calls"].items()}
        log(f"phase 10 {world} rank(s) over {backend} on {dev}: "
            f"{spawn_s:.1f} s; frames match make_frame_fn (3D points within "
            f"{max(e[0] for e in errs):.2e}, fused scores within "
            f"{max(e[1] for e in errs):.2e} relative); sharded frame "
            f"(union, sparse) wall ms {outs[0]['frame_ms']}; collectives "
            f"and bytes a frame {json.dumps(perf['collectives'][world])}")
        if "fit" in outs[0]:
            fit = outs[0]["fit"]
            rel = [abs(a - b) / abs(b) for a, b in
                   zip(fit["train_loss"], ref_fit.history["train_loss"])]
            perf.setdefault("fit", {})[world] = dict(
                fit, single_train_loss=ref_fit.history["train_loss"],
                single_val_loss=ref_fit.history["val_loss"],
                single_epoch_s=ref_epoch_s, train_loss_rel=rel,
                single_self_rel=self_rel,
                step_err=step_err, step_worst=step_worst)
            log(f"phase 10c mesh {PAR_TRAIN_MESHES[world]}: one step "
                f"matches the single-process step within {step_err:.2e} "
                f"(largest: {step_worst}); "
                f"fit train loss {fit['train_loss']} (single-process "
                f"{ref_fit.history['train_loss']}, relative {rel}), val "
                f"loss {fit['val_loss']} (single-process "
                f"{ref_fit.history['val_loss']}); seconds an epoch "
                f"{fit['epoch_s']}")
    if os.path.exists(store):
        os.remove(store)
    missing = [k for k in PAR_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"phase 10: the parallel paths launched no "
                           f"{missing}")
    perf["seconds"] = time.perf_counter() - t_start
    log(f"phase 10: sharded frame wall ms, median of {PAR_TIME_REPEATS} "
        f"(1080x1440, union, CNN; ranks sharing one card, gloo through the "
        f"host at 2 and 4: not a multi-device speed) "
        f"{json.dumps(perf['frame_ms'])}; {card_line()}")
    log(f"phase 10: launches over every rank {json.dumps(launches)}; "
        f"{perf['seconds']:.1f} s")
    return launches, perf


def _par_index(x, i):
    """Frame ``i`` of a batched result leaf (nested named tuples too)."""
    if isinstance(x, tuple):
        return type(x)(*[_par_index(y, i) for y in x])
    return x[i]


def _par_check_fit(world, rank, fit, first):
    """Every rank's fit is rank 0's (the results are replicated) and its
    losses are finite. The fit is not held to the single-process fit's
    losses: the fit turns rounding into differences of its own (see
    PERF.md), so the step above is the equivalence check."""
    same = fit["train_loss"] == first["train_loss"] \
        and fit["val_loss"] == first["val_loss"] \
        and fit["weights_digest"] == first["weights_digest"]
    if not same or not np.all(np.isfinite(fit["train_loss"]
                                          + fit["val_loss"])):
        raise RuntimeError(f"phase 10c {world} ranks, rank {rank}: fit "
                           f"{fit['train_loss']} / {fit['val_loss']} vs "
                           f"rank 0's {first['train_loss']}")


# --------------------------------------------------------------- phase 11 --
# The pipeline- and tensor-parallel LLaVA (parallel/pipeline.py,
# parallel/sharding.py's tensor_parallel_) on ranks that share cuda:0, as
# phase 10's (one rank over nccl, two and four over gloo; gloo copies
# through the host, so no time here is a multi-device speed).
# (a) the GPipe forward of the 7B-width model (32 layers, bf16, seed 0,
# flash prefill) over PIPE_STAGES stages and PIPE_MICRO microbatches,
# logits_last_only, on PIPE_ROWS equal-length rows of packed anyres
# features; again with one stage on one rank; each row's logits against
# LlavaTorch.forward of that row alone on the same weights. The stage
# layers run the microbatches at the shapes of a row alone, so the layers
# agree to the bit, and the head takes the five rows in one product
# where the reference takes one: equal, or within VLA_MAX_LOGIT_DELTA of
# the logits' deviation (phase 6.2's bound), the reading printed.
# Every rank computes every step of the schedule (the bubble steps too,
# as the JAX package does), so a forward launches the flash prefill
# layers / S x (M + S - 1) times a rank: 8 x 8 = 64, 256 over the four
# (160 at S = 1); each of (a) and (b) runs PIPE_FORWARDS forwards.
# (b) pipeline x tensor parallel: two stages of 16 layers, each layer
# Megatron-split over two ranks (dense attention over the local heads,
# as the JAX function): within VLA_MAX_LOGIT_DELTA of the same reference.
# (c) tensor-parallel generate on two ranks from phase 9a's checkpoint
# (7B widths, 2 decoder layers) in bf16, int8 and int4 (group 128): the
# first-step logits within VLA_MAX_LOGIT_DELTA of the single-process
# model's from the same file and mode, the tokens' agreement printed, the
# flash prefill once a layer a prefill on each rank.
# (d) the pipeline-parallel LoRA step at the 7B widths cut to
# PIPE_LORA_LAYERS layers, one a stage, remat, rank-8 f32 adapters with a
# non-zero lora_b (so that lora_a has a gradient too), t = 642 as in phase
# 8b, flash route: each adapter gradient within TRAIN_ROUTE_REL_TOL of its
# norm of the single-process step's (phase 8b's bound).
# (e) dryrun path 3, the TinyVLA LoRA step with its projections and head
# tensor-parallel, on two ranks at the TinyVLA's default widths: loss and
# every gradient (a sharded one against its columns) within
# TRAIN_GRAD_REL_TOL of the single-process step's (another order of the
# same sums).
PIPE_STAGES = 4
PIPE_MICRO = 5
PIPE_ROWS = 5
PIPE_TP = 2
PIPE_TEXT = N_TEXT
PIPE_LORA_LAYERS = 4
PIPE_LORA_RANK = 8
PIPE_LORA_T = 642            # phase 8b's tokens
PIPE_LORA_B_STD = 0.02
PIPE_GEN_TOKENS = 8
PIPE_FORWARDS = 2            # (a) and (b) run twice: the second is warm
PIPE_SEED = 0
PIPE_RANK_TIMEOUT_S = 300.0
PIPE_JOIN_S = 600.0
PIPE_WORLDS = {4: "gloo", 1: "nccl", 2: "gloo"}


def _pipe_setup(device: str = "cuda") -> dict:
    """What a phase-11 rank needs (a spawned rank imports this script
    anew): the model's fields, the TinyVLA's and the checkpoint's."""
    return {"device": device,
            "llava": dict(dtype="bfloat16", prefill_attn_impl="flash",
                          image_grid_pinpoints=VLA_PINPOINTS),
            "vla": dict(lora_rank=8, lora_alpha=32.0),
            "ckpt": CKPT_DIR, "quant_group": QUANT_GROUP}


def _pipe_state(torch, cfg, keep, dev, lora_rank=0):
    """The seed-PIPE_SEED weights of ``LlavaTorch(cfg)`` in bf16 for the
    keys ``keep`` takes (``random_llava_state``: the others are drawn and
    dropped), and every other key on the meta device. With ``lora_rank``
    the adapters are f32 and drawn after the base, every layer's in the
    model's order: lora_a normal(1 / rank), lora_b normal(PIPE_LORA_B_STD)."""
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     random_llava_state)
    from leafgrasp_tpu_torch.vla.lora import is_lora_key
    gen = torch.Generator(device=dev).manual_seed(PIPE_SEED)
    state = random_llava_state(cfg, gen, lambda k: keep(k)
                               and not is_lora_key(k), device=dev,
                               param_dtype=torch.bfloat16)
    meta = LlavaTorch(cfg, device="meta", param_dtype=torch.bfloat16)
    out = {}
    gen = torch.Generator(device=dev).manual_seed(PIPE_SEED + 1)
    for key, p in meta.state_dict().items():
        if is_lora_key(key):
            std = 1.0 / lora_rank if key.endswith("lora_a") \
                else PIPE_LORA_B_STD
            t = torch.empty(p.shape, device=dev).normal_(0.0, std,
                                                         generator=gen)
            out[key] = t if keep(key) else t.to("meta")
        else:
            out[key] = state.get(key, p)
    return out


def _pipe_stage_keep(layers: int, n_stages: int, index: int):
    """The keys of stage ``index`` of ``n_stages`` and of the rest."""
    per = layers // n_stages

    def keep(key):
        if not key.startswith("layers."):
            return True
        return index * per <= int(key.split(".")[1]) < (index + 1) * per
    return keep


def _pipe_inputs(torch, setup):
    """The rows of (a)-(c): ids (PIPE_ROWS, n_img + PIPE_TEXT) of a BOS,
    n_img image tokens and seeded text, and the packed features repeated
    for each row (the prompt layout of the rerank without a left pad)."""
    feats = setup["feats"]
    n_img = feats.shape[0]
    cfg = setup["cfg"]
    rng = np.random.default_rng(PIPE_SEED + 2)
    text = rng.integers(3, cfg.image_token_index - 1000,
                        (PIPE_ROWS, PIPE_TEXT - 1))
    ids = np.concatenate([np.ones((PIPE_ROWS, 1), np.int64),
                          np.full((PIPE_ROWS, n_img), cfg.image_token_index),
                          text], axis=1)
    return ids, feats


def _pipe_forward(torch, dev, mesh, setup, n_stages, tp_axis=None):
    """One rank of (a) or (b): its stage drawn (and TP-sliced), the
    pipelined forward of every row; returns logits, memory and time."""
    from leafgrasp_tpu_torch.parallel import (make_pp_llava_forward,
                                              shard_stage_params,
                                              split_decoder_stages)
    from leafgrasp_tpu_torch.parallel.collectives import Axis
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorch
    cfg = setup["cfg"]
    pp = Axis(mesh, "data")
    _reset_peak(torch, dev)
    state = _pipe_state(torch, cfg, _pipe_stage_keep(cfg.layers, n_stages,
                                                     pp.index), dev)
    stages, rest = split_decoder_stages(state, cfg, n_stages)
    local = shard_stage_params(mesh, stages, tp_axis=tp_axis)
    del state, stages
    meta = LlavaTorch(cfg, device="meta")
    fn = make_pp_llava_forward(mesh, meta, PIPE_MICRO,
                               logits_last_only=True, tp_axis=tp_axis)
    resident = _allocated(torch, dev)
    ids, feats = _pipe_inputs(torch, setup)
    ids = torch.as_tensor(ids, device=dev)
    feats = feats.to(dev).repeat(PIPE_ROWS, 1)
    times = []
    for _ in range(PIPE_FORWARDS):
        fn.axis.reset_counts()
        _sync(torch, dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = fn(rest, local, ids, image_features=feats)
        _sync(torch, dev)
        times.append(time.perf_counter() - t0)
    return {"logits": logits.float().cpu(), "resident_gib": resident,
            "peak_gib": _peak(torch, dev), "seconds": times,
            "hand_offs": (fn.axis.calls, fn.axis.bytes)}


def _pipe_lora_model(torch, dev, setup, keep):
    """(d)'s model state: the 7B widths cut to PIPE_LORA_LAYERS layers,
    bf16 base, f32 adapters."""
    import dataclasses
    cfg = dataclasses.replace(setup["cfg"], layers=PIPE_LORA_LAYERS,
                              lora_rank=PIPE_LORA_RANK,
                              image_grid_pinpoints=None)
    return cfg, _pipe_state(torch, cfg, keep, dev, PIPE_LORA_RANK)


def _pipe_lora_batch(torch, dev, cfg):
    """PIPE_LORA_LAYERS rows of t = PIPE_LORA_T (a BOS, one tile's image
    tokens, seeded text), their pixels and next-token targets."""
    rng = np.random.default_rng(PIPE_SEED + 3)
    b = PIPE_LORA_LAYERS
    text = rng.integers(3, cfg.image_token_index - 1000,
                        (b, PIPE_LORA_T - 1 - cfg.num_patches))
    ids = np.concatenate([np.ones((b, 1), np.int64),
                          np.full((b, cfg.num_patches),
                                  cfg.image_token_index), text], axis=1)
    px = rng.standard_normal((b, cfg.image_size, cfg.image_size, 3)).astype(
        np.float32)
    ids = torch.as_tensor(ids, device=dev)
    return ids, torch.as_tensor(px, device=dev), torch.roll(ids, -1, 1)


def _pipe_nll(torch, logits, tgt):
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, tgt[..., None])[..., 0].mean()


def _pipe_lora(torch, dev, mesh, setup):
    """One rank of (d): its layer's adapter gradients through the
    pipelined step with remat."""
    from leafgrasp_tpu_torch.parallel import (make_pp_llava_forward,
                                              shard_stage_params,
                                              split_decoder_stages)
    from leafgrasp_tpu_torch.parallel.collectives import Axis
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorch
    from leafgrasp_tpu_torch.vla.lora import is_lora_key
    pp = Axis(mesh, "data")
    cfg, state = _pipe_lora_model(torch, dev, setup, _pipe_stage_keep(
        PIPE_LORA_LAYERS, PIPE_LORA_LAYERS, pp.index))
    stages, rest = split_decoder_stages(state, cfg, PIPE_LORA_LAYERS)
    local = shard_stage_params(mesh, stages)
    del state, stages
    for p in rest.parameters():
        p.requires_grad_(False)
    names = [n for n, _ in local.named_parameters()]
    for n, p in local.named_parameters():
        p.requires_grad_(is_lora_key(n))
    fn = make_pp_llava_forward(mesh, LlavaTorch(cfg, device="meta"),
                               PIPE_LORA_LAYERS, remat=True)
    ids, px, tgt = _pipe_lora_batch(torch, dev, cfg)
    _sync(torch, dev)
    t0 = time.perf_counter()
    loss = _pipe_nll(torch, fn(rest, local, ids, px), tgt)
    params = [local.get_parameter(n) for n in names if is_lora_key(n)]
    grads = torch.autograd.grad(loss, params)
    _sync(torch, dev)
    layer = pp.index                      # one layer a stage
    return {"loss": float(loss.detach()),
            "seconds": time.perf_counter() - t0,
            "grads": {f"layers.{layer}.{n.split('.', 1)[1]}": g.cpu()
                      for n, g in zip([n for n in names if is_lora_key(n)],
                                      grads)}}


def _pipe_vla_grads(torch, dev, setup, mesh=None):
    """(e): one TinyVLA LoRA step's loss and adapter gradients at the
    TinyVLA's default widths, tensor-parallel over ``mesh`` or
    single-process; a sharded gradient is this rank's columns."""
    from leafgrasp_tpu_torch.parallel import tensor_parallel_
    from leafgrasp_tpu_torch.vla.convert import torch_to_flax_tiny_vla
    from leafgrasp_tpu_torch.vla.lm import VLAModelConfig
    from leafgrasp_tpu_torch.vla.trainer import (VLATrainer,
                                                 make_synthetic_vla_dataset,
                                                 ranking_to_targets,
                                                 set_trainable)
    trainer = VLATrainer(cfg=VLAModelConfig(**setup["vla"]), device=dev)
    if mesh is not None:
        state = trainer.model.state_dict()
        tensor_parallel_(trainer.model, mesh, lambda k: next(iter(
            torch_to_flax_tiny_vla({k: state[k]}))))
    samples = make_synthetic_vla_dataset(2, seed=PIPE_SEED)
    examples = [trainer._example(s, i, v) for s in samples
                for i, v in ranking_to_targets(s["ranking"]).items()]
    batch = trainer._pad_batch(examples, max(len(e[0]) for e in examples))
    set_trainable(trainer.model, full=False)
    loss = trainer._loss(*batch)
    loss.backward()
    return float(loss.detach()), {
        n.replace(".inner", ""): p.grad.cpu()
        for n, p in trainer.model.named_parameters() if p.grad is not None}


def _pipe_generate(torch, dev, setup, mode, mesh=None):
    """(c): the checkpoint model in ``mode``, tensor-parallel over
    ``mesh`` or single-process: its first-step logits and greedy tokens
    on the rows of (a), and the flash launches of one prefill."""
    from leafgrasp_tpu_torch.kernels import launch_counts
    from leafgrasp_tpu_torch.parallel import tensor_parallel_
    from leafgrasp_tpu_torch.vla.checkpoint_io import load_llava_checkpoint
    from leafgrasp_tpu_torch.vla.convert import llava_flax_name
    from leafgrasp_tpu_torch.vla.llava_torch import greedy_generate_llava
    flag, bits = QUANT_MODES[mode]
    model, _, _ = load_llava_checkpoint(
        setup["ckpt"], dtype="bfloat16", quantize=flag != "none",
        quant_bits=bits, quant_group=setup["quant_group"], device=dev)
    model.set_prefill_attn("flash")
    if mesh is not None:
        tensor_parallel_(model, mesh, llava_flax_name)
    ids, feats = _pipe_inputs(torch, setup)
    ids = torch.as_tensor(ids, device=dev)
    feats = feats.to(dev).repeat(PIPE_ROWS, 1)
    before = launch_counts()["flash_prefill"]
    with torch.no_grad():
        logits = model(ids, image_features=feats, logits_last_only=True)[0]
    prefill = launch_counts()["flash_prefill"] - before
    toks = greedy_generate_llava(model, ids, image_features=feats,
                                 max_new_tokens=PIPE_GEN_TOKENS)
    return {"logits": logits.float().cpu(), "tokens": toks.cpu(),
            "prefill_flash": prefill, "layers": model.cfg.layers}


def _sync(torch, dev):
    if dev != "cpu":
        torch.cuda.synchronize()


def _free(torch, dev):
    if dev != "cpu":
        torch.cuda.empty_cache()


def _reset_peak(torch, dev):
    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _allocated(torch, dev):
    return torch.cuda.memory_allocated() / 2 ** 30 if dev != "cpu" else 0.0


def _peak(torch, dev):
    return torch.cuda.max_memory_allocated() / 2 ** 30 if dev != "cpu" \
        else 0.0


def phase11_rank(rank, world, setup):
    """One rank of phase 11 on ``cuda:0`` (or the CPU, to rehearse): (a),
    (b) and (d) on four ranks, (a) with one stage on one, (c) and (e) on
    two; returns its results on the host and its launch counts."""
    import torch
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.kernels.build import load_library
    from leafgrasp_tpu_torch.parallel import make_mesh
    dev = setup["device"]
    if dev == "cuda":
        # the single-process side computes without TF32 (main), so do
        # the ranks: the TinyVLA's convolutions too
        torch.cuda.set_device(0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        load_library()
    out = {"launches": {}}

    def part(name, fn):
        _sync(torch, dev)
        reset_launch_counts()
        out[name] = fn()
        _sync(torch, dev)
        out["launches"][name] = launch_counts()

    if world == PIPE_STAGES:
        data = make_mesh(world, model_axis=1, device=dev)
        part("pp", lambda: _pipe_forward(torch, dev, data, setup, world))
        tp = make_mesh(world, model_axis=PIPE_TP, device=dev)
        part("pptp", lambda: _pipe_forward(torch, dev, tp, setup,
                                           world // PIPE_TP, "model"))
        part("lora", lambda: _pipe_lora(torch, dev, data, setup))
    elif world == 1:
        mesh = make_mesh(1, device=dev)
        part("pp1", lambda: _pipe_forward(torch, dev, mesh, setup, 1))
    else:
        mesh = make_mesh(world, model_axis=world, device=dev)
        for mode in QUANT_MODES:
            part(f"gen_{mode}", lambda mode=mode: _pipe_generate(
                torch, dev, setup, mode, mesh))
        part("vla", lambda: _pipe_vla_grads(torch, dev, setup, mesh))
    return out


def _pipe_share(got, want) -> float:
    """max |got - want| over the deviation of ``want`` (phase 6.2's)."""
    return float((got - want).abs().max() / want.std())


def _pipe_reference(torch, dev, setup):
    """The single-process side of phase 11, on the card before the ranks
    start (the model freed after each): (a)'s packed features and each
    row's logits alone, (c)'s logits and tokens per mode, (d)'s adapter
    gradients, (e)'s step."""
    from leafgrasp_tpu_torch.vla.llava_next import (
        pack_anyres_features_torch, preprocess_anyres)
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorch
    cfg = setup["cfg"]
    ref = {}
    t0 = time.perf_counter()
    state = _pipe_state(torch, cfg, lambda k: True, dev)
    model = LlavaTorch.from_state(cfg, state)
    del state
    rgb = np.random.default_rng(PIPE_SEED + 4).integers(
        0, 256, (setup["frame"][0], setup["frame"][1], 3), dtype=np.uint8)
    with torch.no_grad():
        tiles, hw = preprocess_anyres(rgb, cfg.image_grid_pinpoints, cfg,
                                      device=dev)
        feats = pack_anyres_features_torch(
            model.vision_project(tiles), hw, cfg.image_grid_pinpoints, cfg,
            model.image_newline)
    setup["feats"] = feats.cpu()
    ids, _ = _pipe_inputs(torch, setup)
    rows = []
    with torch.no_grad():
        for r in range(PIPE_ROWS):
            rows.append(model(torch.as_tensor(ids[r:r + 1], device=dev),
                              image_features=feats,
                              logits_last_only=True)[0].float().cpu())
    ref["logits"] = torch.cat(rows)
    ref["model_gib"] = sum(p.numel() * p.element_size()
                           for p in model.parameters()) / 2 ** 30
    del model, tiles
    _free(torch, dev)
    ref["t"] = ids.shape[1]

    lcfg, lstate = _pipe_lora_model(torch, dev, setup, lambda k: True)
    lmodel = LlavaTorch.from_state(lcfg, lstate)
    del lstate
    for n, p in lmodel.named_parameters():
        p.requires_grad_(n.endswith(("lora_a", "lora_b")))
    lids, px, tgt = _pipe_lora_batch(torch, dev, lcfg)
    loss = _pipe_nll(torch, lmodel(lids, px)[0], tgt)
    names = [n for n, p in lmodel.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [lmodel.get_parameter(n)
                                       for n in names])
    ref["lora_loss"] = float(loss.detach())
    ref["lora_grads"] = {n: g.cpu() for n, g in zip(names, grads)}
    del lmodel, grads, loss
    _free(torch, dev)

    ref["gen"] = {mode: _pipe_generate(torch, dev, setup, mode)
                  for mode in QUANT_MODES}
    ref["vla"] = _pipe_vla_grads(torch, dev, setup)
    _free(torch, dev)
    ref["seconds"] = time.perf_counter() - t0
    return ref


def run_phase_11(torch, setup=None):
    """Phase 11: the pipeline- and tensor-parallel LLaVA on 4, 1 and 2
    ranks of one card (``setup``: ``_pipe_setup``'s plus the frame size
    and config, on the card by default)."""
    from leafgrasp_tpu_torch.parallel.launch import run_ranks
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorchConfig
    setup = dict(setup or _pipe_setup())
    setup.setdefault("frame", (H, W))
    setup["cfg"] = LlavaTorchConfig(**setup["llava"])
    dev = setup["device"]
    _free(torch, dev)
    t_start = time.perf_counter()
    ref = _pipe_reference(torch, dev, setup)
    log(f"phase 11: references in {ref['seconds']:.1f} s: {PIPE_ROWS} rows "
        f"of t = {ref['t']} ({setup['feats'].shape[0]} packed anyres rows), "
        f"the whole model {ref['model_gib']:.2f} GiB")

    store = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_pipe_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    launches, outs, perf = {}, {}, {"spawn_s": {}}
    for world, backend in PIPE_WORLDS.items():
        t0 = time.perf_counter()
        outs[world] = run_ranks(phase11_rank, world, store, setup,
                                backend="gloo" if dev == "cpu" else backend,
                                timeout_s=PIPE_RANK_TIMEOUT_S,
                                join_s=PIPE_JOIN_S, threads=2)
        perf["spawn_s"][world] = time.perf_counter() - t0
        for out in outs[world]:
            for counts in out["launches"].values():
                for name, n in counts.items():
                    launches[name] = launches.get(name, 0) + n
    if os.path.exists(store):
        os.remove(store)

    # (a) and (b): every rank's logits against each row alone
    want = ref["logits"]
    for tag, world, key in (("a", 4, "pp"), ("a", 1, "pp1"),
                            ("b", 4, "pptp")):
        res = [o[key] for o in outs[world]]
        for rank, r in enumerate(res):
            if not torch.equal(r["logits"], res[0]["logits"]):
                raise RuntimeError(f"phase 11{tag} {key}: rank {rank}'s "
                                   f"logits differ from rank 0's")
        got = res[0]["logits"]
        equal = torch.equal(got, want)
        share = _pipe_share(got, want)
        flash = [o["launches"][key].get("flash_prefill", 0)
                 for o in outs[world]]
        perf[key] = {"equal": equal, "share": share, "flash": flash,
                     "resident_gib": [r["resident_gib"] for r in res],
                     "peak_gib": [r["peak_gib"] for r in res],
                     "seconds": [r["seconds"] for r in res],
                     "hand_offs": res[0]["hand_offs"]}
        log(f"phase 11{tag} {key} on {world} rank(s): logits bit-equal to "
            f"each row alone: {equal}; largest difference / deviation "
            f"{share:.3e}; flash launches a rank {flash}; per-rank "
            f"resident {perf[key]['resident_gib']} GiB, peak "
            f"{perf[key]['peak_gib']} GiB (the whole model "
            f"{ref['model_gib']:.2f}); forward seconds "
            f"{perf[key]['seconds']}; collectives on the pipeline axis "
            f"{res[0]['hand_offs']}")
        if share > VLA_MAX_LOGIT_DELTA:
            raise RuntimeError(f"phase 11{tag} {key}: logits differ by "
                               f"{share} of their deviation")
    n_steps = PIPE_MICRO + PIPE_STAGES - 1
    per = setup["cfg"].layers // PIPE_STAGES
    want_pp = per * n_steps * PIPE_FORWARDS
    want_pp1 = setup["cfg"].layers * PIPE_MICRO * PIPE_FORWARDS
    if dev != "cpu" and (perf["pp"]["flash"] != [want_pp] * PIPE_STAGES
                         or perf["pp1"]["flash"] != [want_pp1]):
        raise RuntimeError(f"phase 11a: flash launches {perf['pp']['flash']}"
                           f" and {perf['pp1']['flash']} in "
                           f"{PIPE_FORWARDS} forwards, not {want_pp} a rank "
                           f"and {want_pp1}")
    if max(perf["pp"]["peak_gib"]) >= ref["model_gib"] and dev != "cpu":
        raise RuntimeError(f"phase 11a: a rank's peak "
                           f"{perf['pp']['peak_gib']} GiB is not below the "
                           f"whole model's {ref['model_gib']:.2f}")

    # (c) tensor-parallel generate
    for mode in QUANT_MODES:
        w = ref["gen"][mode]
        for rank, out in enumerate(outs[2]):
            g = out[f"gen_{mode}"]
            share = _pipe_share(g["logits"], w["logits"])
            agree = float((g["tokens"] == w["tokens"]).float().mean())
            log(f"phase 11c {mode} rank {rank}: first-step logits within "
                f"{share:.3e} of their deviation, tokens agree "
                f"{agree:.3f}, flash launches of a prefill "
                f"{g['prefill_flash']}")
            if share > VLA_MAX_LOGIT_DELTA \
                    or (dev != "cpu" and g["prefill_flash"] != g["layers"]):
                raise RuntimeError(f"phase 11c {mode} rank {rank}: logits "
                                   f"{share}, {g['prefill_flash']} flash "
                                   f"launches a prefill")
        perf[f"gen_{mode}"] = share

    # (d) the pipeline-parallel LoRA step
    errs = {}
    for rank, out in enumerate(outs[4]):
        r = out["lora"]
        if abs(r["loss"] - ref["lora_loss"]) > 1e-3 * abs(ref["lora_loss"]):
            raise RuntimeError(f"phase 11d rank {rank}: loss {r['loss']} "
                               f"against {ref['lora_loss']}")
        for name, g in r["grads"].items():
            errs[name] = _rel_err(g, ref["lora_grads"][name])
    if set(errs) != set(ref["lora_grads"]):
        raise RuntimeError("phase 11d: the ranks' adapters are not the "
                           "model's")
    worst = max(errs, key=errs.get)
    lora_flash = {k: [o["launches"]["lora"].get(k, 0) for o in outs[4]]
                  for k in ("flash_prefill", "flash_prefill_bwd_dq",
                            "flash_prefill_bwd_dkv")}
    perf["lora"] = {"worst": errs[worst], "worst_name": worst,
                    "loss": ref["lora_loss"], "flash": lora_flash,
                    "seconds": [o["lora"]["seconds"] for o in outs[4]]}
    log(f"phase 11d: the pipelined LoRA step ({PIPE_LORA_LAYERS} layers, "
        f"remat, t = {PIPE_LORA_T}) loss {outs[4][0]['lora']['loss']:.6f} "
        f"(single-process {ref['lora_loss']:.6f}); adapter gradients within "
        f"{errs[worst]:.2e} of their norm ({worst}); launches a rank "
        f"{json.dumps(lora_flash)}; seconds {perf['lora']['seconds']}")
    if errs[worst] > TRAIN_ROUTE_REL_TOL or (
            dev != "cpu" and min(min(v) for v in lora_flash.values()) == 0):
        raise RuntimeError(f"phase 11d: gradient {errs[worst]} ({worst}), "
                           f"launches {lora_flash}")

    # (e) the tensor-parallel TinyVLA step
    loss_ref, g_ref = ref["vla"]
    for rank, out in enumerate(outs[2]):
        loss, grads = out["vla"]
        idx = rank % 2
        worst_e = abs(loss - loss_ref) / abs(loss_ref)
        for name, g in grads.items():
            w = g_ref[name]
            if g.shape != w.shape:
                dim = [a != b for a, b in zip(g.shape, w.shape)].index(True)
                w = w.chunk(2, dim)[idx]
            worst_e = max(worst_e, _rel_err(g, w))
        if set(grads) != set(g_ref) or worst_e > TRAIN_GRAD_REL_TOL:
            raise RuntimeError(f"phase 11e rank {rank}: step differs by "
                               f"{worst_e}")
        perf["vla"] = worst_e
    log(f"phase 11e: the tensor-parallel TinyVLA step matches the "
        f"single-process step within {perf['vla']:.2e}")

    missing = [k for k in ("flash_prefill", "flash_prefill_bwd_dq",
                           "flash_prefill_bwd_dkv")
               if launches.get(k, 0) == 0]
    if missing and dev != "cpu":
        raise RuntimeError(f"phase 11: the pipeline paths launched no "
                           f"{missing}")
    # the f32 forward's share of the flash launches: 11c computes in f32,
    # and 11d's residual stream is f32 from its first adapter on
    perf["f32_flash"] = sum(
        o["launches"][k].get("flash_prefill", 0) for o in outs[2] + outs[4]
        for k in o["launches"] if k.startswith("gen_") or k == "lora")
    perf["seconds"] = time.perf_counter() - t_start
    bubble = (PIPE_STAGES - 1) / n_steps
    log(f"phase 11: bubble (S - 1) / (M + S - 1) = {bubble:.3f}; spawns "
        f"{json.dumps(perf['spawn_s'])} s (ranks sharing one card, gloo "
        f"through the host at 2 and 4: not a multi-device speed); launches "
        f"over every rank {json.dumps(launches)}; {perf['seconds']:.1f} s; "
        f"{card_line() if dev != 'cpu' else 'cpu'}")
    return launches, perf


# --------------------------------------------------------------- phase 12 --

# the evaluation, parity and training tools (tools/*_torch.py) run through
# their ``main``s: the evaluations at the committed records' scenes and
# sizes, the training CLIs at a cut size (TOOLS_TRAIN_CUTS)
TOOLS_OUT = os.path.join("build", "chip_smoke_tools")
# a cut for the script's time
TOOLS_FUZZ_CROSS_CHECK = 5
TOOLS_HARD = ["--hard", "--arch", "deep", "--ckpt",
              os.path.join("artifacts", "torch", "grasp_cnn_hard",
                           "best_model")]
# (name, --check record, flags) of the system-accuracy runs: each
# record's scenes (the plain record holds seeds 100-117, 14 of them live:
# it was made with --scenes 18; the hard one with the default 30). The
# hard record with the per-patch min-max (artifacts/
# system_accuracy_hard.json) is left out and the train_stats one runs
# its first 10 of 30 scenes, for the script's time; each run is held to
# the record's rows among the scenes it drew
TOOLS_ACCURACY = (
    ("system_accuracy", "artifacts/system_accuracy.json",
     ["--scenes", "18"]),
    ("system_accuracy_hard_trainstats",
     "artifacts/system_accuracy_hard_trainstats.json",
     TOOLS_HARD + ["--norm", "train_stats", "--scenes", "10"]))
# the VLA record of today's JAX tool with the pretrained base grafted into
# its scorer and the prompts it printed (tests/test_torch_tools_vla.py);
# the committed record's scorer ran on freshly initialized decoder
# projections (ROADMAP C), so only its geometric columns are held
TOOLS_VLA_RECORD = os.path.join("artifacts", "torch", "reference",
                                "system_accuracy_vla.json")
TOOLS_VLA_COMMITTED = os.path.join("artifacts", "system_accuracy_vla.json")
# the port's own answers on the CPU (tools/eval_vla_system_torch.py
# --device cpu): the card must give every row and column of them
TOOLS_VLA_PORT_CPU = os.path.join("artifacts", "torch", "reference",
                                  "system_accuracy_vla_port_cpu.json")
TOOLS_TRAIN_CUTS = {
    "train_reference_model_torch": ["--frames", "4", "--epochs", "2"],
    "make_training_corpus_torch": ["--frames", "4", "--fresh"],
    "train_best_config_torch": ["--data", TRAIN_CORPUS, "--arch", "deep",
                                "--epochs", "2"],
    "run_cnn_sweep_torch": ["--data", TRAIN_CORPUS, "--limit", "2",
                            "--epochs", "1"],
    "train_vla_sweep_torch": ["--num-train", "8", "--num-eval", "4",
                              "--pretrain-epochs", "1"]}
TOOLS_KERNELS = ("fused_score_maps", "minplus_pass2", "fused_attention_gate")
TOOLS_DEVICE = "cuda"


def _tool(torch, perf, name, module, argv, phase="12", **kw):
    """One tool's ``main`` (module ``module``) on the card: its summary;
    its wall time and launches go into ``perf``."""
    import importlib
    from leafgrasp_tpu_torch.kernels import launch_counts
    from tools._torch_bench import free_memory
    free_memory(torch.device("cuda"))
    before = launch_counts()
    t0 = time.perf_counter()
    try:
        out = importlib.import_module(module).main(argv, **kw)
    except SystemExit as exc:           # a failed correctness check
        raise RuntimeError(f"phase {phase} {name}: {exc}") from None
    torch.cuda.synchronize()
    after = launch_counts()
    perf[name] = {"s": time.perf_counter() - t0,
                  "launches": {k: after[k] - before.get(k, 0)
                               for k in after if after[k] - before.get(k, 0)}}
    log(f"phase {phase} {name}: {perf[name]['s']:.1f} s, launches "
        f"{json.dumps(perf[name]['launches'])}")
    return out


def _tool_check(name, ok, what, phase="12") -> None:
    if not ok:
        raise RuntimeError(f"phase {phase} {name}: {what}")


def _phase12_parity(torch, perf):
    """12a: parity against PARITY.json and PARITY_production.json."""
    for scale, n in (("golden", 26), ("production", 16)):
        out = _tool(torch, perf, f"parity_{scale}",
                    "tools.parity_report_torch", ["--scale", scale, "--out",
                     os.path.join(TOOLS_OUT, f"parity_{scale}.json")])
        eq = [out[k] for k in ("leaf_equal", "uv_equal", "degenerate_equal",
                               "message_equal")]
        _tool_check(f"parity_{scale}", out["mismatches"] == 0
                    and out["scenes"] == n and eq == [n] * 4
                    and out["oracle_uv_equal"] == out["oracle_uv_rows"],
                    json.dumps(out)[:600])
        log(f"phase 12a parity {scale}: {n} scenes at {out['frame']}: leaf, "
            f"pixel, flag, message equal to JAX's record {eq}; the oracle's "
            f"pixel {out['oracle_uv_equal']}/{out['oracle_uv_rows']}; "
            f"{out['degenerate_scenes']} degenerate")


def _phase12_fuzz(torch, perf):
    """12b: the fuzzer's counts against artifacts/fuzz_parity.json's, its
    first cases against the port's CPU path."""
    out = _tool(torch, perf, "fuzz", "tools.fuzz_parity_torch",
                ["--cross-check", str(TOOLS_FUZZ_CROSS_CHECK), "--out",
                 os.path.join(TOOLS_OUT, "fuzz.json")])
    _tool_check("fuzz", out["mismatch_count"] == 0 and out["stats_compared"]
                and out["cross_checked"] == TOOLS_FUZZ_CROSS_CHECK,
                json.dumps(out)[:600])
    log(f"phase 12b fuzz: {out['stats']} against the record's "
        f"{out['record_stats']}; {out['cross_checked']} cases equal to the "
        f"CPU path (found, degenerate, leaf, pixel, message)")


def _phase12_accuracy(torch, perf):
    """12c: the system accuracy, plain and hard, with the converted
    CNNs."""
    for name, record, extra in TOOLS_ACCURACY:
        scenes = int(extra[extra.index("--scenes") + 1])
        with open(record) as f:
            n = sum(r["seed"] < 100 + scenes for r in json.load(f)["rows"])
        out = _tool(torch, perf, name, "tools.eval_system_accuracy_torch",
                    extra + ["--check", record, "--out",
                             os.path.join(TOOLS_OUT, f"{name}.json")])
        _tool_check(name, not out["mismatches"] and out["scenes"] == n
                    and out["rows_equal"] == n, json.dumps(out)[:800])
        log(f"phase 12c {name}: {out['rows_equal']}/{n} rows equal to "
            f"{record} ({out['cnn_source']}, {out['patch_normalization']}; "
            f"leaf agreement {out['leaf_agreement']}, px shift mean "
            f"{out['px_shift_mean']})")


def _phase12_vla(torch, perf):
    """12d: the VLA system evaluation through two GraspServices, held to
    the port's CPU record on every row and column, to today's JAX tool
    (grafted) on the geometric columns and on the VLA columns wherever
    the scorer's prompts print what JAX's printed, and to the committed
    record on the geometric columns."""
    from tools._torch_eval import compare_rows
    from tools.eval_vla_system_torch import check_rows
    path = os.path.join(TOOLS_OUT, "system_accuracy_vla.json")
    out = _tool(torch, perf, "vla_system", "tools.eval_vla_system_torch",
                ["--check", TOOLS_VLA_PORT_CPU, "--out", path])
    _tool_check("vla_system", not out["mismatches"]
                and out["rows_equal"] == out["rows_compared"]
                == out["rows_vla_compared"] == out["scenes"]
                and out["prompts_equal"] == out["prompts_compared"],
                json.dumps(out)[:800])
    with open(path) as f:
        mine = json.load(f)
    with open(TOOLS_VLA_RECORD) as f:
        jax_ref = json.load(f)
    vs_jax = check_rows(mine["rows"], mine["prompts"], jax_ref,
                        range(100, 100 + 26))
    _tool_check("vla_system", not vs_jax["mismatches"],
                f"against {TOOLS_VLA_RECORD}: {vs_jax}")
    with open(TOOLS_VLA_COMMITTED) as f:
        committed = json.load(f)["rows"]
    common = {r["seed"] for r in mine["rows"]} & {r["seed"]
                                                  for r in committed}
    rows = [r for r in mine["rows"] if r["seed"] in common]
    geo = compare_rows(rows, committed, common, ("leaf_geo", "uv_geo"))
    vla = compare_rows(rows, committed, common,
                       ("leaf_vla", "strategy", "vla_leaf"))
    _tool_check("vla_system", not geo, f"geometric columns differ from "
                f"{TOOLS_VLA_COMMITTED}: {geo}")
    log(f"phase 12d vla_system: {out['rows_equal']}/{out['scenes']} rows "
        f"equal to the port's CPU record {TOOLS_VLA_PORT_CPU}, every "
        f"column; against {TOOLS_VLA_RECORD}: {vs_jax['rows_equal']} of "
        f"{vs_jax['rows_compared']} common rows equal, the geometric "
        f"columns all, the VLA columns on the {vs_jax['rows_vla_compared']} "
        f"whose prompts print what JAX's printed "
        f"({vs_jax['prompts_equal']}/{vs_jax['prompts_compared']} reranked "
        f"frames; the others part in a centroid's last bit, ROADMAP C); "
        f"against {TOOLS_VLA_COMMITTED} (a scorer with untrained "
        f"projections): {len(common)} common scenes, geometric columns "
        f"equal, {len(vla)} VLA fields differ; "
        f"{out['strategy_distribution']}")


def _phase12_train(torch, perf):
    """12e: each training CLI once at a cut size; returns the gate's
    backward launches."""
    from leafgrasp_tpu_torch.kernels import launch_counts
    log(f"phase 12e cuts: {json.dumps(TOOLS_TRAIN_CUTS)}")
    before = launch_counts()["attention_gate_backward"]
    for module, cut in TOOLS_TRAIN_CUTS.items():
        out = _tool(torch, perf, module, f"tools.{module}",
                    cut + ["--out", os.path.join(TOOLS_OUT, module)])
        log(f"phase 12e {module}: {json.dumps(out)[:400]}")
        if "experiments" in out:
            ok = len(out["experiments"]) == 4 and all(
                np.isfinite(r["final_loss"]) for r in out["experiments"])
        elif "runs" in out:
            ok = out["runs"] == 2 and out["best_f1"] is not None
        elif "best_val_loss" in out:
            ok = np.isfinite(out["best_val_loss"]) and os.path.exists(
                out["checkpoint"]) and out["device"] == TOOLS_DEVICE
        else:
            ok = out["samples"] > 0 and out["device"] == TOOLS_DEVICE
        _tool_check(module, ok, json.dumps(out)[:600])
    return launch_counts()["attention_gate_backward"] - before


def run_phase_12(torch):
    """Phase 12: the port's evaluation, parity and training tools on the
    card, each held against the JAX package's committed records."""
    import shutil
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    # the collectors resume from what a run left on disk
    shutil.rmtree(TOOLS_OUT, ignore_errors=True)
    os.makedirs(TOOLS_OUT)
    perf = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t_start = time.perf_counter()
    _phase12_parity(torch, perf)
    _phase12_fuzz(torch, perf)
    _phase12_accuracy(torch, perf)
    _phase12_vla(torch, perf)
    train_bwd = _phase12_train(torch, perf)
    counts = launch_counts()
    missing = [k for k in TOOLS_KERNELS if counts[k] == 0]
    _tool_check("launches", not missing and train_bwd > 0,
                f"the tools launched no {missing} (gate backward "
                f"{train_bwd})")
    per_frame = {k: v / 16 for k, v in
                 perf["parity_production"]["launches"].items()}
    perf["seconds"] = time.perf_counter() - t_start
    log(f"phase 12: launches a production parity frame "
        f"{json.dumps(per_frame)}; over the tools {json.dumps(counts)}; "
        f"{perf['seconds']:.1f} s; {card_line()}")
    return counts, perf


# --------------------------------------------------------------- phase 13 --

# the measurement tools (bench_torch.py, tools/bench_*_torch.py) through
# their ``main``s, each cut in depth only (PERF.md section 4)
BENCH_OUT = os.path.join("build", "chip_smoke_bench")
BENCH_PER_FAMILY = 8                    # bench.py's default is 28
BENCH_INGEST_FRAMES = 40                # 200
BENCH_RUNS = (
    # (name, module, argv)
    ("bench", "bench_torch", []),
    ("ingest", "tools.bench_service_ingest_torch",
     ["--frames", str(BENCH_INGEST_FRAMES)]),
    ("vla", "tools.bench_vla_torch", ["--layers", "8"]),
    ("anyres", "tools.bench_vla_anyres_torch",
     ["--quantize", "int8", "--layers", "8", "--frames", "1", "--stages",
      "--flash-ab"]),
    ("quant_int8", "tools.bench_vla_quant_torch", ["--bits", "8"]),
    ("quant_int4", "tools.bench_vla_quant_torch",
     ["--bits", "4", "--skip-bf16"]),
    ("service", "tools.bench_vla_service_torch",
     ["--quantize", "int8", "--anyres", "--frames", "4", "--json", "--out",
      os.path.join(BENCH_OUT, "vla_service_bench_anyres.json")]),
    ("stability", "tools.bench_rerank_stability_torch",
     ["--layers", "4", "--frames", "4", "--int8"]))
BENCH_KERNELS = ("fused_score_maps", "minplus_pass2", "fused_attention_gate",
                 "flash_prefill")
# the runs whose rerank takes the flash prefill (anyres)
BENCH_FLASH_RUNS = ("anyres", "service")


def _bench_check(name, ok, what) -> None:
    _tool_check(name, ok, what, phase="13")


def _phase13_frames(answers):
    """13a: each family's first bench frame in each configuration against
    the port's CPU path (the tool's seeded CNN and configs)."""
    import bench_torch
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.models.grasp_cnn import init_grasp_cnn
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    cfgs = dict(zip(("reference_self", "union"), bench_torch.bench_configs()))
    cnn, _ = init_grasp_cnn(0, cfgs["union"].model)
    cnn = cnn.eval()
    for mode, cfg in cfgs.items():
        fn = make_frame_fn(cfg, with_cnn=True, device="cpu")
        for fi, (name, n, seed, margin) in enumerate(bench_torch.FAMILIES):
            fam, leaf, uv, found, deg = answers[mode][fi * BENCH_PER_FAMILY]
            mask, depth = make_leaf_scene(H, W, num_leaves=n, seed=seed,
                                          margin=margin)
            ref = fn(mask, depth, *bench_torch.CAMERA, cnn)
            want = (int(ref.leaf_id), ref.grasp_uv.tolist(),
                    bool(ref.found), bool(ref.degenerate))
            log(f"phase 13a bench {mode}/{name}: card (leaf, uv, found, "
                f"degenerate) {(leaf, uv, found, deg)} cpu {want}")
            _bench_check("bench", fam == name
                         and (leaf, uv, found, deg) == want,
                         f"{mode}/{name}: card {(leaf, uv, found, deg)} "
                         f"!= cpu {want}")


def _phase13_ingest(torch, rec, published):
    """13b: the ingest tool ran the native bus, and every message it
    published equals a synchronous service's for that mask and depth."""
    from leafgrasp_tpu_torch.io.scenes import default_projection
    from leafgrasp_tpu_torch.models.grasp_cnn import init_grasp_cnn
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    from tools.bench_service_ingest_torch import ingest_config, raw_frames
    _bench_check("ingest", rec["bus"] == "native",
                 f"the service ran the {rec['bus']} frame bus")
    _bench_check("ingest", published and rec["frames_processed"]
                 == len(published), json.dumps(rec))
    cfg = ingest_config()
    raws = raw_frames(cfg, BENCH_INGEST_FRAMES)
    cnn, _ = init_grasp_cnn(0, cfg.model)
    svc = GraspService(cfg, cnn=cnn.to("cuda").eval(), min_interval_s=0.0)
    svc.set_camera_params(default_projection())
    for mask_stamp, depth_stamp, msg in published:
        want = svc.process_frame(raws[mask_stamp][0],
                                 raws[depth_stamp][1])["message"]
        _bench_check("ingest", msg == want,
                     f"frame ({mask_stamp}, {depth_stamp}) published "
                     f"{msg}, the synchronous service {want}")
    svc.stop()
    log(f"phase 13b ingest: the native bus; {len(published)} published "
        f"messages of {BENCH_INGEST_FRAMES} pushed frames equal the "
        f"synchronous service's ({rec['frames_dropped']} dropped by the "
        f"newest-frame bus)")


def run_phase_13(torch):
    """Phase 13: the port's measurement tools on the card, each record
    checked."""
    import shutil
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    shutil.rmtree(BENCH_OUT, ignore_errors=True)
    os.makedirs(BENCH_OUT)
    perf, recs = {}, {}
    answers, published = {}, []
    extra = {"bench": {"answers": answers}, "ingest": {"published": published}}
    old = os.environ.get("LEAFGRASP_BENCH_PER_FAMILY")
    os.environ["LEAFGRASP_BENCH_PER_FAMILY"] = str(BENCH_PER_FAMILY)
    torch.cuda.synchronize()
    reset_launch_counts()
    t_start = time.perf_counter()
    try:
        for name, module, argv in BENCH_RUNS:
            recs[name] = _tool(torch, perf, name, module, argv,
                               phase="13", **extra.get(name, {}))
    finally:
        if old is None:
            os.environ.pop("LEAFGRASP_BENCH_PER_FAMILY")
        else:
            os.environ["LEAFGRASP_BENCH_PER_FAMILY"] = old
    counts = launch_counts()
    t_runs = time.perf_counter() - t_start
    _phase13_frames(answers)
    _phase13_ingest(torch, recs["ingest"], published)
    svc = recs["service"]
    _bench_check("service", svc["inner_degradation_uniform_scores_ok"]
                 and svc["degraded_geometric_fallback_ok"]
                 and svc["vla_reranked_frames"] > 0, json.dumps(svc)[:600])
    _bench_check("stability", [r["tag"] for r in recs["stability"]]
                 == ["bf16", "int8"] and all(
                     np.isfinite(r["max_first_step_dlogit_over_std"])
                     for r in recs["stability"]), recs["stability"])
    _bench_check("quant", all(recs[q][f"{k}_step_ms"] > 0 for q, k in
                              (("quant_int8", "int8"), ("quant_int4", "int4"),
                               ("quant_int8", "bf16"))), "a step of 0 ms")
    missing = [k for k in BENCH_KERNELS if counts[k] == 0]
    no_flash = [n for n in BENCH_FLASH_RUNS
                if not perf[n]["launches"].get("flash_prefill")]
    _bench_check("launches", not missing and not no_flash,
                 f"the tools launched no {missing}; no flash prefill in "
                 f"{no_flash}")
    perf["seconds"] = time.perf_counter() - t_start
    log(f"phase 13: the tools ran in {t_runs:.1f} s; launches over the "
        f"tools {json.dumps(counts)}; {perf['seconds']:.1f} s; "
        f"{card_line()}")
    for name, rec in recs.items():
        log(f"phase 13 record {name} {json.dumps(rec)}")
    return counts, perf


# --------------------------------------------------------------- phase 14 --

# the frame's A/B and stage tools (tools/micro_bench_*_torch.py) through
# their ``main``s at the production frame, each cut in depth only: fewer
# repeats, 2 frames a family for the knob A/B (8)
MICRO_RUNS = (
    # (name, module, argv)
    ("frame_ab", "tools.micro_bench_frame_ab_torch",
     ["--reps", "1", "--per-family", "2"]),
    ("edt_ab", "tools.micro_bench_edt_ab_torch",
     ["--trials", "1", "--reps", "5"]),
    ("batch", "tools.micro_bench_batch_torch", ["--trials", "1"]),
    ("stages", "tools.micro_bench_stages_torch",
     ["--n", "2", "--reps", "1", "--no-profile"]))
# K1, K3/K4, K2, K5 (edt_batch) and K6 (leaf_stats with the histogram)
MICRO_KERNELS = ("fused_score_maps", "minplus_pass2", "fused_attention_gate",
                 "squared_edt_rowband", "segment_histogram")
MICRO_FRAMES = ("stages/frame_reference_self", "stages/frame_union",
                "iso/frame_reference_self", "iso/frame_union")


def _micro_check(name, ok, what) -> None:
    _tool_check(name, ok, what, phase="14")


def _phase14_frames(outputs):
    """The stage tool's full frames against the port's CPU path: the same
    leaf, pixel and flag (the tool's seeded CNN, scenes and camera)."""
    import dataclasses
    from leafgrasp_tpu_torch.config import DEFAULT_CONFIG
    from leafgrasp_tpu_torch.models.grasp_cnn import init_grasp_cnn
    from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    from leafgrasp_tpu_torch.utils.device import fetch_to_host
    from tools import micro_bench_stages_torch as stages
    from tools._torch_eval import CAMERA
    cnn, _ = init_grasp_cnn(0, DEFAULT_CONFIG.model)
    cnn = cnn.eval()
    cam = [np.float32(v) for v in CAMERA]
    for key in MICRO_FRAMES:
        group, stage = key.split("/")
        mode = stage[len("frame_"):]
        cfg = DEFAULT_CONFIG.replace(grasp=dataclasses.replace(
            DEFAULT_CONFIG.grasp, isolation_context=mode))
        name = "crowded" if group == "stages" else "sparse"
        mask, depth = stages.scene(DEFAULT_CONFIG, name, "cpu")
        ref = make_frame_fn(cfg, with_cnn=True, device="cpu")(
            mask, depth, *cam, cnn)
        res = fetch_to_host(outputs[key])
        got = (int(res.leaf_id), res.grasp_uv.tolist(), bool(res.found))
        want = (int(ref.leaf_id), ref.grasp_uv.tolist(), bool(ref.found))
        log(f"phase 14 stages {key} ({name}): card (leaf, uv, found) {got} "
            f"cpu {want}")
        _micro_check("stages", got == want and got[2],
                     f"{key}: card {got} != cpu {want}")


def run_phase_14(torch):
    """Phase 14: the frame's A/B and stage tools on the card, each tool's
    own checks and the stage tool's frames against the CPU path."""
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    perf, recs, outputs = {}, {}, {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t_start = time.perf_counter()
    for name, module, argv in MICRO_RUNS:
        kw = {"outputs": outputs} if name == "stages" else {}
        recs[name] = _tool(torch, perf, name, module, argv, phase="14", **kw)
    counts = launch_counts()
    t_runs = time.perf_counter() - t_start
    _micro_check("frame_ab", recs["frame_ab"]["identical_pixels"],
                 "the knob variants' pixels differ")
    _micro_check("edt_ab", recs["edt_ab"]["routes_bit_equal"],
                 "the EDT routes differ")
    _micro_check("batch", recs["batch"]["batched_equal_single"],
                 "batched frames differ from single frames")
    _micro_check("stages", recs["stages"]["envelope_maxes_agree"],
                 "the envelope settings' maxima differ")
    _phase14_frames(outputs)
    missing = [k for k in MICRO_KERNELS if counts[k] == 0]
    _micro_check("launches", not missing, f"the tools launched no {missing}")
    perf["seconds"] = time.perf_counter() - t_start
    log(f"phase 14: the tools ran in {t_runs:.1f} s; launches over the "
        f"tools {json.dumps(counts)}; {perf['seconds']:.1f} s; "
        f"{card_line()}")
    for name, rec in recs.items():
        log(f"phase 14 record {name} {json.dumps(rec)}")
    return counts, perf


def check_flash_split(torch, dev):
    """Phase 15a: the flash prefill at latent attention's split heads
    against its plain version, then its time at the MoE rerank's
    shape."""
    import torch.nn.functional as F
    from leafgrasp_tpu_torch.kernels.flash_prefill import (
        flash_prefill, flash_prefill_plain)
    shapes = {"ragged": ((2, 257, 16, 192, 128), (130, 70)),
              "path": ((5, 2400, 16, 192, 128), (0, 1, 64, 700, 2399))}
    rng = np.random.default_rng(15)
    errs, shares = {}, {}
    for name, ((b, t, heads, hd, hdv), pads) in shapes.items():
        q = torch.as_tensor(rng.standard_normal((b, t, heads, hd)),
                            device=dev).to(torch.bfloat16)
        k = torch.as_tensor(rng.standard_normal((b, t + 10, heads, hd)),
                            device=dev).to(torch.bfloat16)
        v = torch.as_tensor(rng.standard_normal((b, t + 10, heads, hdv)),
                            device=dev).to(torch.bfloat16)
        k[:, t:] = float("nan")               # beyond t: never to be read
        v[:, t:] = float("nan")
        pad = torch.tensor(pads, dtype=torch.int32, device=dev)
        got = flash_prefill(q, k, v, pad)
        torch.cuda.synchronize()
        want = flash_prefill_plain(q, k, v, pad, chunk=256)
        errs[name], shares[name], over = flash_diff(got, want,
                                                    FLASH_TOL["bfloat16"])
        pad_zero = all(not got[i, :p].any() for i, p in enumerate(pads))
        finite = bool(torch.isfinite(got.float()).all())
        log(f"phase 15a flash_prefill split {(b, t, heads, hd, hdv)} pads "
            f"{pads}: max abs err {errs[name]}, over the tolerance by "
            f"{over} (must be <= 0), pad rows zero {pad_zero}, finite "
            f"{finite}")
        if got.shape != (b, t, heads, hdv) or not (
                over <= 0.0 and pad_zero and finite):
            raise RuntimeError(f"flash_prefill split {name}: shape "
                               f"{tuple(got.shape)}, over the tolerance by "
                               f"{over}, pad rows zero {pad_zero}, finite "
                               f"{finite}")
        del got, want
    (b, t, heads, hd, hdv), _ = shapes["path"]
    pad0 = torch.zeros((b,), dtype=torch.int32, device=dev)
    k, v = k[:, :t].contiguous(), v[:, :t].contiguous()
    ops = b * 2.0 * heads * (hd + hdv) * t * (t + 1) / 2
    moved = 2.0 * b * t * heads * (2 * hd + 2 * hdv) + 4.0 * b
    b_ms, b_by = bound(moved, ops, PEAK_BF16_OPS_PER_S)
    ql, kl, vl = (x.transpose(1, 2) for x in (q, k, v))
    lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_err, _, lib_over = flash_diff(flash_prefill(q, k, v, pad0),
                                      lib.transpose(1, 2),
                                      FLASH_TOL["bfloat16"])
    if not lib_over <= 0.0:
        raise RuntimeError(f"flash_prefill split against the library "
                           f"call: err {lib_err}, over by {lib_over}")
    rec = {"name": "flash_prefill_192_128", "route": "cuda",
           "source": "leafgrasp_tpu_torch/kernels/csrc/flash_prefill.cu",
           "replaces": "none (the JAX package has no latent attention)",
           "tolerance_rel": FLASH_TOL["bfloat16"]["rel"],
           "tolerance_row": FLASH_TOL["bfloat16"]["row"],
           "max_abs_err": max(errs.values()),
           "max_row_share": max(shares.values()),
           "shape": [b, t, heads, heads, hd, hdv],
           "ms": kernel_ms(lambda: flash_prefill(q, k, v, pad0),
                           "flash_prefill_kernel", iters=10),
           "plain_ms": cuda_ms(
               lambda: flash_prefill_plain(q, k, v, pad0, chunk=480),
               iters=2, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               ql, kl, vl, is_causal=True), iters=10),
           "max_abs_diff_vs_library": lib_err, "operations": ops,
           "bytes": moved}
    log(f"phase 15a {json.dumps(rec)}")
    return rec


def check_flash_offset(torch, dev):
    """Phase 15d: the flash prefill as the rerank's shared route calls it,
    both bf16 instantiations (32 query heads over 8 of 128; latent
    attention's 16 of 192/128): the image prefix, one row of 2340 tokens
    at offset 0, and the rows' text, five rows of 60 queries at offset
    2340 over 2400 keys, each against its plain version, then their
    times beside the single pass over five rows of 2400."""
    from leafgrasp_tpu_torch.kernels.flash_prefill import (
        flash_prefill, flash_prefill_plain)
    n_img, n_text, b = 2340, 60, 5
    keys = n_img + n_text
    rng = np.random.default_rng(16)
    out = {"name": "flash_prefill_offset", "route": "cuda",
           "source": "leafgrasp_tpu_torch/kernels/csrc/flash_prefill.cu",
           "replaces": "none (the TPU kernel runs every row's prompt)",
           "tolerance_rel": FLASH_TOL["bfloat16"]["rel"],
           "tolerance_row": FLASH_TOL["bfloat16"]["row"]}
    for name, (heads, kvh, hd, hdv) in (("hd128", (32, 8, 128, 128)),
                                        ("split_192_128",
                                         (16, 16, 192, 128))):
        def t_(*shape):
            return torch.as_tensor(rng.standard_normal(shape)
                                   .astype(np.float32),
                                   device=dev).to(torch.bfloat16)
        k, v = t_(b, keys, kvh, hd), t_(b, keys, kvh, hdv)
        q = t_(b, keys, heads, hd)
        pad0 = torch.zeros((b,), dtype=torch.int32, device=dev)
        calls = {"prefix": (q[:1, :n_img], k[:1], v[:1], pad0[:1], 0),
                 "suffix": (q[:, n_img:], k, v, pad0, n_img),
                 "full": (q, k, v, pad0, 0)}
        rec = {}
        for call, (qq, kk, vv, pp, o) in calls.items():
            got = flash_prefill(qq, kk, vv, pp, o)
            torch.cuda.synchronize()
            want = flash_prefill_plain(qq, kk, vv, pp, o, chunk=240)
            err, share, over = flash_diff(got, want, FLASH_TOL["bfloat16"])
            if not over <= 0.0 or not bool(torch.isfinite(got.float()).all()):
                raise RuntimeError(f"phase 15d {name} {call}: over the "
                                   f"tolerance by {over}")
            rows, t = qq.shape[:2]
            pairs = rows * heads * (t * o + t * (t + 1) / 2)
            ops = 2.0 * (hd + hdv) * pairs
            moved = 2.0 * (rows * t * heads * (hd + hdv)
                           + rows * (o + t) * kvh * (hd + hdv))
            b_ms, b_by = bound(moved, ops, PEAK_BF16_OPS_PER_S)
            rec[call] = {
                "shape": [rows, t, o, heads, kvh, hd, hdv],
                "max_abs_err": err, "max_row_share": share,
                "ms": kernel_ms(lambda: flash_prefill(qq, kk, vv, pp, o),
                                "flash_prefill_kernel", iters=10),
                "plain_ms": cuda_ms(lambda: flash_prefill_plain(
                    qq, kk, vv, pp, o, chunk=240), iters=2, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by, "operations": ops,
                "bytes": moved}
            del got, want
            log(f"phase 15d flash_prefill {name} {call} "
                f"{json.dumps(rec[call])}")
        out[name] = rec
    out["max_abs_err"] = max(out[n][c]["max_abs_err"]
                             for n in ("hd128", "split_192_128")
                             for c in ("prefix", "suffix", "full"))
    log(f"phase 15d {json.dumps(out)}")
    return out


def check_moe_experts(torch, dev):
    """Phase 15b: the grouped expert kernel against its plain version at
    a prompt pass's and a decode step's tokens, an expert idle in each,
    and its times."""
    from leafgrasp_tpu_torch.kernels.moe_experts import (
        expert_counts, moe_experts, moe_experts_plain)
    e, k, hidden, width = 64, 6, 2048, 1408
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    ws = [(torch.randn(shape, generator=gen, device=dev) * 0.02)
          .to(torch.bfloat16) for shape in ((e, width, hidden),
                                            (e, width, hidden),
                                            (e, hidden, width))]
    rec = {"name": "moe_experts", "route": "triton",
           "source": "leafgrasp_tpu_torch/kernels/moe_experts.py",
           "replaces": "none (the JAX package has no expert layer)",
           "tolerance_rel": 2.0 ** -6, "tolerance_row": 2.0 ** -6,
           "experts": e, "per_token": k, "hidden": hidden, "width": width}
    for name, n_tok, idle in (("prefill", 12000, (3,)),
                              ("decode", 5, (0,))):
        x = torch.randn((n_tok, hidden), generator=gen, device=dev) \
            .to(torch.bfloat16)
        score = torch.rand((n_tok, e), generator=gen, device=dev)
        score[:, list(idle)] = -1.0
        ids = torch.topk(score, k, dim=-1).indices
        w = torch.rand((n_tok, k), generator=gen, device=dev)
        counts = expert_counts(ids, e)
        got = moe_experts(x, ids, w, *ws)
        want = moe_experts_plain(x, ids, w, *ws)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        allowed = 2.0 ** -6 * want.float().abs() \
            + 2.0 ** -6 * want.float().abs().amax(-1, keepdim=True)
        over = float((diff - allowed).max())
        read = int((counts > 0).sum())
        log(f"phase 15b moe_experts {name}: {n_tok} tokens, {read} experts "
            f"read, idle {idle} without pairs "
            f"{[int(counts[i]) for i in idle]}; max abs err "
            f"{float(diff.max())}, over the tolerance by {over} (must be "
            f"<= 0)")
        if over > 0.0 or any(int(counts[i]) for i in idle) \
                or not bool(torch.isfinite(got.float()).all()):
            raise RuntimeError(f"moe_experts {name}: over the tolerance "
                               f"by {over}")
        pairs = n_tok * k
        ops = 2.0 * 3 * hidden * width * pairs
        moved = read * 3.0 * hidden * width * 2 + 2.0 * n_tok * hidden * 2
        b_ms, b_by = bound(moved, ops, PEAK_BF16_OPS_PER_S)
        rec[name] = {
            "tokens": n_tok, "experts_read": read,
            "max_abs_err": float(diff.max()),
            "ms": kernel_ms(lambda: moe_experts(x, ids, w, *ws),
                            ("moe_experts_gate_up_kernel",
                             "moe_experts_down_kernel"), iters=10),
            "wrapper_ms": cuda_ms(lambda: moe_experts(x, ids, w, *ws),
                                  iters=10),
            "plain_ms": cuda_ms(lambda: moe_experts_plain(x, ids, w, *ws),
                                iters=2, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "operations": ops,
            "bytes": moved}
        del got, want
    rec["max_abs_err"] = max(rec[n]["max_abs_err"]
                             for n in ("prefill", "decode"))
    log(f"phase 15b {json.dumps(rec)}")
    return rec


def run_phase_15(torch, dev):
    """Phase 15: the deepseek_v3 decoder's kernels, then a rerank over
    the whole decoder with its launches counted."""
    from leafgrasp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from leafgrasp_tpu_torch.vla.llava_runtime import LlavaTorchScorer
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     init_random_)
    t0 = time.perf_counter()
    with torch.no_grad():
        records = [check_flash_split(torch, dev),
                   check_flash_offset(torch, dev),
                   check_moe_experts(torch, dev)]
    torch.cuda.empty_cache()
    cfg = LlavaTorchConfig(
        decoder="deepseek_v3", dtype="bfloat16", prefill_attn_impl="flash",
        image_grid_pinpoints=VLA_PINPOINTS, hidden=2048, intermediate=11264,
        layers=27, heads=16, kv_heads=16, vocab_size=163840,
        rope_theta=50000.0, rms_eps=1e-5, image_token_index=163839,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, n_routed_experts=64, num_experts_per_tok=6,
        n_shared_experts=2, moe_intermediate_size=1408,
        first_k_dense_replace=1, routed_scaling_factor=2.446,
        norm_topk_prob=True)
    model = LlavaTorch(cfg, device=dev, param_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    init_random_(model, gen, std=0.02)
    n_params = sum(p.numel() for p in model.parameters())
    scorer = LlavaTorchScorer(model, FixedLenTok(cfg.vocab_size),
                              max_new_tokens=10, anyres=True)
    rgb = (np.random.default_rng(15).uniform(0, 255, (H, W, 3))
           .astype(np.uint8))
    rng = np.random.default_rng(16)
    cands = [dict(leaf_id=i + 1, x=float(rng.uniform(100, W - 100)),
                  y=float(rng.uniform(100, H - 100)),
                  clutter_score=float(rng.uniform(0.2, 1.0)),
                  distance_score=float(rng.uniform(0.2, 1.0)),
                  visibility_score=float(rng.uniform(0.2, 1.0)),
                  geometric_score=float(rng.uniform(0.2, 1.0)))
             for i in range(5)]
    instruction = "Select the best leaf for grasping"
    scorer.score(rgb, cands, instruction)      # captures the decode graph
    torch.cuda.synchronize()
    reset_launch_counts()
    scores = scorer.score(rgb, cands, instruction)
    torch.cuda.synchronize()
    counts = launch_counts()
    last = scorer.last
    # the shared route: a flash launch a layer for the prefix and one for
    # the rows' text, and one expert call a layer over both
    want = {"flash_prefill": 2 * cfg.layers,
            "moe_experts": cfg.layers - cfg.first_k_dense_replace}
    log(f"phase 15c rerank over {n_params / 1e9:.3f} G parameters: scores "
        f"{scores}; t {last['prompt_len']}, image tokens "
        f"{last['n_image_tokens']}, route {last['decode_graph']}, "
        f"launches {json.dumps(counts)}, load "
        f"{[round(float(np.median(b)), 3) for b in last['moe_load']]}")
    if last["decode_graph"] != "replayed" \
            or last["prefill_route"] != "shared" \
            or any(counts[key] != n for key, n in want.items()) \
            or len(scores) != len(cands):
        raise RuntimeError(f"phase 15c: routes {last['decode_graph']}, "
                           f"{last['prefill_route']}, launches {counts}, "
                           f"want {want}")
    for rec in records:
        rec["launches_moe_serve"] = counts["flash_prefill" if
                                           rec["name"].startswith("flash")
                                           else rec["name"]]
        rec["launches"] = rec["launches_moe_serve"]
    del model, scorer
    torch.cuda.empty_cache()
    return records, {"seconds": time.perf_counter() - t0}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    try:
        from leafgrasp_tpu_torch.config import (DEFAULT_CONFIG,
                                                GraspScoringConfig,
                                                ModelConfig)
        from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
        from leafgrasp_tpu_torch.kernels.build import load_library
        from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                          init_random_)
        from leafgrasp_tpu_torch.pipeline.frame import make_frame_fn
    except ImportError as exc:
        print(f"leafgrasp_tpu_torch not importable: {exc}", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; TF32 off")

    t_start = t0 = time.perf_counter()
    load_library(verbose=True)
    log(f"phase 1: kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    if sys.argv[1:] == ["--phase", "15"]:
        moe_records, moe_perf = run_phase_15(torch, dev)
        log(f"phase 15: the deepseek_v3 decoder's kernels held their plain "
            f"versions and served a rerank ({moe_perf['seconds']:.1f} s)")
        log(card_line())
        print(json.dumps({"kernels": moe_records}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:]:
        print(f"usage: chip_smoke.py [--phase 15], got {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    scenes = {name: make_leaf_scene(H, W, num_leaves=n, seed=seed,
                                    margin=margin)
              for name, n, seed, margin in FAMILIES}
    with torch.no_grad():
        records = check_kernels(torch, dev, *scenes["sparse"])
    log("phase 2: every kernel matches its plain version")

    model_cpu = init_random_(GraspPointCNN(ModelConfig()), seed=0).eval()
    model = copy.deepcopy(model_cpu).to(dev).eval()
    cfgs = {mode: DEFAULT_CONFIG.replace(
        grasp=GraspScoringConfig(isolation_context=mode)) for mode in MODES}
    fns = {name: make_frame_fn(cfgs[iso], with_cnn=True, hist_median=hist)
           for name, (iso, hist) in VARIANTS.items()}
    for mode in VARIANTS:    # warm-up (allocator, cuDNN plans), uncounted
        fns[mode](*scenes["sparse"], CX, CY, F, model)
    results, counts, reads, frame_ms = run_frames(torch, dev, fns, model,
                                                  scenes)
    n_frames = len(VARIANTS) * len(FAMILIES) * FRAMES_PER_CELL
    log(f"phase 3: {n_frames} frames; launches {json.dumps(counts)}; host "
        f"reads {reads} ({reads / n_frames:.1f} per frame)")
    for key, val in frame_ms.items():
        log(f"frame_ms {key} {json.dumps(val)}")
    missing = [k for k, v in counts.items()
               if v == 0 and k not in NOT_ON_FRAMES]
    if missing:
        raise RuntimeError(f"the main path launched no {missing}")
    cross_check(results, cfgs, model_cpu, scenes)
    log("phase 3: card frames match the CPU path")
    run_wide_frames(torch, cfgs, model, model_cpu)
    log(f"phase 3c: {WIDE_H}x{WIDE_W} frames match the CPU path")
    run_5mp_frame(torch, cfgs, model, model_cpu)
    log(f"phase 3d: the {MP5_H}x{MP5_W} frame matches the CPU path")

    profile_frames(torch, fns, model, scenes)
    log("phase 4: profiled")

    service_counts = run_service(torch, dev, cfgs[SERVICE_MODE], model,
                                 model_cpu, scenes)

    with torch.no_grad():
        vla_counts, rerank_perf = run_vla(torch, dev, model, scenes)
    records.append(rerank_perf["decode_attention"])
    log("phase 6: the VLA serve path ran at full width")

    records.append(check_attention_backward(torch, dev))
    teacher_counts = run_teacher(torch, dev, scenes)
    train_counts, train_perf = run_training(torch, dev)
    log(f"phase 7: the teacher labelled frames and the trainer trained the "
        f"standard CNN on the card ({train_perf['epochs']} epochs, median "
        f"{train_perf['median_epoch_s']:.3f} s an epoch)")

    train_records, fwd_train, vla_train_counts, vla_bf16_counts, \
        vla_perf = run_phase_8(torch, dev)
    records.extend(train_records)
    flash = next(r for r in records if r["name"] == "flash_prefill")
    f32 = fwd_train.pop("f32")
    f32["max_abs_err"] = max(f32["max_abs_err"], flash["max_abs_err_f32"])
    flash["training_shape"] = fwd_train
    flash["f32"] = f32
    log(f"phase 8: the LLaVA LoRA trainer trained at full width on the card "
        f"({vla_perf['step_s']:.3f} s a step, "
        f"{vla_perf['tokens_per_s']:.0f} tokens/s)")

    ckpt_counts, int8_counts, quant_perf = run_phase_9(torch, dev,
                                                       rerank_perf)
    log(f"phase 9: a full-width checkpoint served in bf16, int8 and int4; "
        f"the 7B model served in int8 "
        f"({quant_perf['resident_gib']:.2f} GiB resident, rerank "
        f"{quant_perf['rerank_wall_ms']:.1f} ms)")

    par_counts, par_perf = run_phase_10(torch, results, cfgs, model)
    log(f"phase 10: the parallel layer ran on 1, 2 and 4 ranks "
        f"({par_perf['seconds']:.1f} s)")

    pipe_counts, pipe_perf = run_phase_11(torch)
    log(f"phase 11: the pipeline- and tensor-parallel LLaVA ran on 4, 1 "
        f"and 2 ranks ({pipe_perf['seconds']:.1f} s)")

    tool_counts, tool_perf = run_phase_12(torch)
    log(f"phase 12: the evaluation, parity and training tools held the "
        f"committed records on the card ({tool_perf['seconds']:.1f} s)")

    bench_counts, bench_perf = run_phase_13(torch)
    log(f"phase 13: the measurement tools ran on the card and their "
        f"records held ({bench_perf['seconds']:.1f} s)")

    micro_counts, micro_perf = run_phase_14(torch)
    log(f"phase 14: the frame's A/B and stage tools ran on the card and "
        f"their checks held ({micro_perf['seconds']:.1f} s)")

    moe_records, moe_perf = run_phase_15(torch, dev)
    log(f"phase 15: the deepseek_v3 decoder's kernels held their plain "
        f"versions and served a rerank ({moe_perf['seconds']:.1f} s)")

    phases = {"frames": counts, "service": service_counts,
              "vla_service": vla_counts, "teacher": teacher_counts,
              "train": train_counts, "vla_train": vla_train_counts,
              "vla_train_bf16": vla_bf16_counts,
              "checkpoint_serve": ckpt_counts, "int8_serve": int8_counts,
              "parallel": par_counts, "pipeline": pipe_counts,
              "tools": tool_counts, "bench": bench_counts,
              "micro": micro_counts}
    for rec in records:
        for phase, cnt in phases.items():
            rec[f"launches_{phase}"] = cnt.get(rec["name"], 0)
        rec["launches"] = sum(cnt.get(rec["name"], 0)
                              for cnt in phases.values())
        if rec["launches"] == 0:
            raise RuntimeError(f"no path launched {rec['name']}")
    # the f32 forward runs on the f32 LoRA step's path (phase 8b), in the
    # checkpoint's f32-compute serving (phase 9a) and in phase 11's
    # tensor-parallel generate and pipelined LoRA step (11c, 11d)
    f32["launches"] = vla_train_counts["flash_prefill"] \
        + ckpt_counts["flash_prefill"] + pipe_perf["f32_flash"]
    records.extend(moe_records)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
