"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper (``minplus.minplus_pass2``, ``scoring.fused_score_maps``,
``attention.fused_attention_gate``,
``attention.attention_gate_backward``, ``rowband.squared_edt_rowband``,
``histogram.segment_histogram``, ``flash_prefill.flash_prefill``, the
two launches of ``flash_prefill.flash_prefill_backward``,
``moe_experts.moe_experts``, whose one count stands for its two Triton
launches, and ``decode_attention.decode_attention``, whose one count
stands for its two) takes the
plain PyTorch version for a CPU tensor and launches its kernel for a
CUDA tensor; it adds one to its count where it launches, and nowhere
else.
"""

from __future__ import annotations

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts"]

LAUNCHES = {"minplus_pass2": 0, "fused_score_maps": 0,
            "fused_attention_gate": 0, "attention_gate_backward": 0,
            "squared_edt_rowband": 0,
            "segment_histogram": 0, "flash_prefill": 0,
            "flash_prefill_bwd_dq": 0, "flash_prefill_bwd_dkv": 0,
            "moe_experts": 0, "decode_attention": 0}


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
