"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit). A share of a peak is stated against these, with
the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # outside the tensor cores (TF32 off)
BF16_FLOP_PER_S = 989e12        # dense tensor cores

PEAK_FLOP_PER_S = {"float32": F32_FLOP_PER_S, "bfloat16": BF16_FLOP_PER_S}


def least_seconds(flop: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for this work: the larger of
    its operations at the type's peak and its bytes at the HBM peak."""
    return max(flop / PEAK_FLOP_PER_S[dtype], nbytes / HBM_BYTES_PER_S)
