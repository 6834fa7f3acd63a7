"""Work counted from shapes for the deepseek_v3 decoder (latent attention,
routed and shared experts), on ``core.work``'s terms: products only,
inputs read once and outputs written once, a prefix the rows share
counted once. ``c`` is the program's ``LlavaTorchConfig``.

* Active products only: a token's routed experts (``num_experts_per_tok``
  of them), the shared experts and the router, never the experts it was
  not routed to.
* Attention as published: per-head keys of ``qk_nope_head_dim +
  qk_rope_head_dim`` and values of ``v_head_dim`` (192 and 128 at
  Moonlight's widths), whatever form the program computes it in.
* The grouped expert product: the routed pairs' SwiGLU products; its
  bytes the weights of each expert that had pairs in a call, once a
  call, and the tokens' rows in and out.
"""

from __future__ import annotations

from benchmark.core import work


def _layers(c):
    """(dense layers, expert layers)."""
    n_dense = min(c.first_k_dense_replace, c.layers)
    return n_dense, c.layers - n_dense


def decoder_token_flop(c) -> float:
    """Active products of one token through the decoder's layers, less
    attention's score and value products."""
    h, hh, r = c.hidden, c.heads, c.kv_lora_rank
    dn, dr, dv = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
    attn = h * hh * (dn + dr) + h * (r + dr) + r * hh * (dn + dv) \
        + hh * dv * h
    dense = 3 * h * c.intermediate
    moe = h * c.n_routed_experts \
        + 3 * h * c.moe_intermediate_size * (c.num_experts_per_tok
                                             + c.n_shared_experts)
    n_dense, n_moe = _layers(c)
    return 2.0 * (c.layers * attn + n_dense * dense + n_moe * moe)


def attention_flop(c, pairs: int) -> float:
    """QK^T and PV over ``pairs`` causal pairs in every layer and head."""
    return 2.0 * pairs * c.heads * (c.qk_nope_head_dim + c.qk_rope_head_dim
                                    + c.v_head_dim) * c.layers


def prefill_attention_flop(c, prompts) -> float:
    """The prompt pass's attention: its causal pairs, a shared prefix
    once."""
    return attention_flop(c, work.shared_prefix_pairs(prompts))


def prefill_attention_bytes(c, prompts, itemsize: int = 2) -> float:
    """Q and K (nope + rope) and V and O (v) of every distinct prompt
    token, every head, once each."""
    dqk = c.qk_nope_head_dim + c.qk_rope_head_dim
    return float(itemsize * work.distinct_tokens(prompts) * c.heads
                 * 2 * (dqk + c.v_head_dim) * c.layers)


def rerank_flop(c, prompts, fed, n_tiles: int) -> float:
    """The products a rerank needs: the tower over its tiles and the
    projector, every distinct token of the rows fed to the decoder once,
    ``lm_head`` where a token is read, and the causal attention of those
    tokens."""
    from benchmark.models.llava_rerank import tower_flop
    distinct = work.distinct_tokens(fed)
    reads = sum(len(f) - len(p) + 1 for p, f in zip(prompts, fed))
    return (tower_flop(c, n_tiles) + distinct * decoder_token_flop(c)
            + reads * 2.0 * c.hidden * c.vocab_size
            + attention_flop(c, work.shared_prefix_pairs(fed)))


def expert_flop(c, pairs: float) -> float:
    """The grouped expert product's operations: a routed pair's gate, up
    and down products."""
    return 2.0 * 3.0 * c.hidden * c.moe_intermediate_size * pairs


def expert_bytes(c, pairs: float, experts_read: float,
                 itemsize: int = 2) -> float:
    """The grouped expert product's bytes: each expert with pairs in a
    call read once for that call (gate, up and down), each token's row
    read and its result written."""
    weights = 3.0 * c.hidden * c.moe_intermediate_size * itemsize
    tokens = pairs / max(c.num_experts_per_tok, 1)
    return experts_read * weights + 2.0 * tokens * c.hidden * itemsize
