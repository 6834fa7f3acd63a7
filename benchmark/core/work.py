"""Work counted from shapes: the operations and bytes that the inputs
need, whatever implements them. A roofline share or an ``mfu`` divides
the least time of this work at the card's peaks (``core.peaks``) by a
measured time, so a later program that does less work than today's
kernels issue still reads at most 100%.

* Bytes: each input byte read once and each output byte written once.
* Operations: a multiply-add is two. Matrix products and convolutions
  only: elementwise work is left to the bytes.
* An exact EDT pass is linear in its pixels: its bound is its bytes,
  not the min-plus operations a brute-force kernel issues.
* Attention: the causal pairs the rows need, with a prefix that several
  rows share counted once (``shared_prefix_pairs``).
"""

from __future__ import annotations

from typing import Dict, Sequence


# ------------------------------------------------------------- the CNN --

def cnn_forward_flop(model: Dict, n: int, patch: int) -> float:
    """Operations of ``n`` forward passes of the GraspPointCNN of
    ``model`` (a ``ModelConfig`` as a dict) on (patch, patch) inputs:
    two 3x3 convolutions a block with 2x2 pooling after it, the gate,
    three dense layers and the head."""
    ch, hw, flop = int(model["in_channels"]), patch, 0.0
    for f in model["encoder_filters"]:
        flop += 2.0 * hw * hw * 9 * ch * f + 2.0 * hw * hw * 9 * f * f
        ch, hw = f, hw // 2
    mode = model["attention_type"]
    if mode in ("spatial", "hybrid"):
        flop += 2.0 * hw * hw * ch
    if mode in ("channel", "hybrid"):
        r = max(ch // int(model["se_reduction"]), 1)
        flop += 4.0 * ch * r
    widths = (ch, ch // 2, ch // 4)
    prev = ch
    for w in widths:
        flop += 2.0 * prev * w
        prev = w
    flop += 2.0 * prev
    return n * flop


def cnn_train_step_flop(model: Dict, batch: int, patch: int) -> float:
    """A training step: the forward, and a backward of twice its
    operations (the gradients of activations and of weights)."""
    return 3.0 * cnn_forward_flop(model, batch, patch)


# ------------------------------------------------------------- the EDT --

def minplus_bytes(rows: int, width: int, nq: int, qcol_numel: int = 0,
                  band_numel: int = 0) -> int:
    """A pass-2 min-plus: the (rows, width) f32 field read, the
    (rows, nq) f32 result written, the int32 query columns and band."""
    return 4 * (rows * width + rows * nq + qcol_numel + band_numel)


def rowband_bytes(c: int, h: int, w: int) -> int:
    """The row-banded EDT: the (c, h, w) f32 field read and written."""
    return 4 * 2 * c * h * w


# --------------------------------------------------------- attention --

def shared_prefix_pairs(rows: Sequence[Sequence[int]]) -> int:
    """Causal (query, key) pairs that ``rows`` of token ids need when
    every distinct prefix is computed once: each node of the rows' trie
    at depth d (1-based) attends to d keys."""
    trie: dict = {}
    pairs = 0
    for row in rows:
        node = trie
        for depth, tok in enumerate(row, start=1):
            if tok not in node:
                node[tok] = {}
                pairs += depth
            node = node[tok]
    return pairs


def distinct_tokens(rows: Sequence[Sequence[int]]) -> int:
    """Tokens of ``rows`` once a shared prefix is counted once."""
    trie: dict = {}
    n = 0
    for row in rows:
        node = trie
        for tok in row:
            if tok not in node:
                node[tok] = {}
                n += 1
            node = node[tok]
    return n


def attention_flop(pairs: int, heads: int, head_dim: int,
                   layers: int) -> float:
    """QK^T and PV over ``pairs``: 4 head_dim operations a pair, a head,
    a layer."""
    return 4.0 * pairs * heads * head_dim * layers


def attention_bytes(tokens: int, heads: int, kv_heads: int, head_dim: int,
                    layers: int, itemsize: int = 2) -> int:
    """Q and O of every distinct token, K and V of every distinct token,
    once each."""
    return itemsize * tokens * head_dim * (2 * heads + 2 * kv_heads) * layers
