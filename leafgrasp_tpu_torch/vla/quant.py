"""Weight-only int8 and int4 quantization of the LLaVA language model: the
port of leafgrasp_tpu/vla/quant.py.

The Mistral projections and ``lm_head`` hold symmetric quantized weights
beside f32 scales; the vision tower, projector, embedding and norms stay
in the compute type.

int8: for a kernel W (in, out), scale_j = max_i |W_ij| / 127 and
Q = round(W / scale) in int8, stored (in, out); y = (x @ Q) * scale, with
the product's result in f32, scaled in f32 and rounded once to the
compute type. Rounding the product to bf16 before the scale double-rounds
every logit: in the JAX package that flipped 100 of 100 greedy paths
between the batched and the one-by-one rerank. On the CPU the product is
an f32 product of the (bf16-exact) values, each term exact in f32; on
the card one library product with an f32 result (``torch.mm`` with
``out_dtype``), never a bf16 result before the scale.

int4: group-wise scales (G, out), G = in / group groups along the input
dimension, |q| <= 7. torch has no int4 type, so Q is stored as the JAX
package's ``packed`` form: (in / 2, out) int8, row 2i in the low nibble
and row 2i + 1 in the high one. JAX's native ``jnp.int4`` holds the same
values, and ``vla/convert.py`` packs it. The product has two
formulations, switched on the token count as in JAX: above
``dequant_threshold`` tokens (a prompt pass) the weight is dequantized
(f32 codes times scales, rounded to the compute type) and multiplied
once; at or below (decode) each group's partial product comes back in
f32, is scaled, and the groups are summed.

The weight conversion that XLA fuses into the product is a separate
tensor here (the int8 codes in the compute type, or the dequantized int4
weight), written and read once a call.

``quantize_kernel`` quantizes on the tensor's own device with true f32
division and round-half-to-even, so the card and the CPU give the same
codes and scales as the JAX package's host quantizer.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from leafgrasp_tpu_torch.vla.lora import LoRADense

__all__ = ["QuantDense", "QuantLoRADense", "quantize_llava_variables",
           "quantize_llava_state_device",
           "quantize_llava_variables_device", "quantize_kernel",
           "quant_dense_plain", "quant_dense_exact", "one_rounding_share",
           "is_quantized_weight", "pack_nibbles",
           "LM_PROJ_NAMES"]

#: projection module names whose kernels quantize (the LoRA target set
#: plus lm_head)
LM_PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj", "lm_head")


def _num_groups(in_features: int, bits: int, group: int) -> int:
    """Scale rows of a kernel: int8, and int4 with ``group <= 0`` or a
    group that does not divide ``in_features``, are per channel (one
    row); otherwise ``in_features / group`` rows."""
    if bits == 8 or group <= 0 or in_features % group != 0:
        return 1
    return in_features // group


def _unpack_nibbles(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 packed bytes -> (low, high) sign-extended int4 values as
    int8: row 2i of the kernel is the low nibble, row 2i + 1 the high."""
    return ((p & 0xF) ^ 8) - 8, p >> 4


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """(in, out) integer codes in [-8, 7] -> (in / 2, out) int8, row 2i in
    the low nibble and row 2i + 1 in the high one."""
    qi = q.to(torch.int16)
    return ((qi[0::2] & 0xF) | ((qi[1::2] & 0xF) << 4)) \
        .to(torch.uint8).view(torch.int8)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D or batched 3-D) with an f32 result. bf16 and f16
    values are exact in f32, so every term of the sum is exact. On the
    card one cuBLAS product with an f32 output (``out_dtype`` exists for
    CUDA only)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        op = torch.mm if a.dim() == 2 else torch.bmm
        return op(a, b, out_dtype=torch.float32)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


class QuantDense(nn.Module):
    """Bias-free linear layer over a quantized kernel and f32 scales.

    bits=8: ``kernel_q`` (in, out) int8, ``kernel_scale`` (out,) f32.
    bits=4: ``kernel_q`` (in / 2, out) int8 (two nibbles a byte along the
    input dimension), ``kernel_scale`` (G, out) f32.
    Filled by ``quantize_llava_variables`` (or the loader), never trained.
    ``dtype`` is the compute type; the output has it.
    """

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, bits: int = 8,
                 group: int = 128, dequant_threshold: int = 256,
                 device=None):
        super().__init__()
        if bits not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        g = _num_groups(in_features, bits, group)
        if bits == 4 and (in_features // g) % 2:
            raise ValueError(
                f"packed int4 needs an even group size, got "
                f"{in_features // g} (in={in_features}, groups={g})")
        self.in_features, self.features = in_features, features
        self.compute_dtype = dtype
        self.bits, self.groups = bits, g
        self.dequant_threshold = dequant_threshold
        rows = in_features if bits == 8 else in_features // 2
        self.kernel_q = nn.Parameter(
            torch.zeros((rows, features), dtype=torch.int8, device=device),
            requires_grad=False)
        self.kernel_scale = nn.Parameter(
            torch.ones((features,) if bits == 8 else (g, features),
                       dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        lead = x.shape[:-1]
        xc = x.to(dt).reshape(-1, self.in_features)
        q, s = self.kernel_q, self.kernel_scale
        if self.bits == 8:
            y = _product_f32(xc, q.to(dt)) * s
        elif xc.shape[0] > self.dequant_threshold:
            y = xc @ self.dequantized()
        else:
            g, out = self.groups, self.features
            half = self.in_features // g // 2
            lo, hi = _unpack_nibbles(q)
            # (g, n, gs / 2) against (g, gs / 2, out): f32 partials a group
            xg = xc.reshape(-1, g, half, 2).permute(1, 0, 2, 3)
            part = (_product_f32(xg[..., 0].contiguous(),
                                 lo.to(dt).reshape(g, half, out))
                    + _product_f32(xg[..., 1].contiguous(),
                                   hi.to(dt).reshape(g, half, out)))
            y = (part * s[:, None, :]).sum(dim=0)
        return y.to(dt).reshape(*lead, self.features)

    def dequantized(self) -> torch.Tensor:
        """int4: the (in, out) weight in the compute type, f32 codes times
        their group's scale rounded once."""
        g, out = self.groups, self.features
        lo, hi = _unpack_nibbles(self.kernel_q)
        qi = torch.stack([lo, hi], dim=1).reshape(g, -1, out)
        w = qi.to(torch.float32) * self.kernel_scale[:, None, :]
        return w.to(self.compute_dtype).reshape(self.in_features, out)


def _dense_in(layer: QuantDense, x: torch.Tensor,
              acc: torch.dtype) -> torch.Tensor:
    """x in the compute type times the (in, out) codes times their
    scales, in ``acc`` on ``x``'s device, unrounded."""
    dt, out = layer.compute_dtype, layer.features
    q = layer.kernel_q
    if layer.bits == 4:
        lo, hi = _unpack_nibbles(q)
        q = torch.stack([lo, hi], dim=1).reshape(layer.in_features, out)
    s = layer.kernel_scale.reshape(-1, 1, out).to(acc)
    w = (q.to(acc).reshape(s.shape[0], -1, out) * s).reshape(
        layer.in_features, out)
    y = x.to(dt).to(acc).reshape(-1, layer.in_features) @ w
    return y.reshape(*x.shape[:-1], out)


def quant_dense_plain(layer: QuantDense, x: torch.Tensor) -> torch.Tensor:
    """The function ``layer`` computes, written plainly in f32 on ``x``'s
    device: x in the compute type, times the (in, out) codes times their
    scales, summed in f32 and rounded once to the compute type. The
    layer's formulations round at other places (int4's dequantized
    weight is rounded to the compute type before its product), so a
    comparison with it states its tolerance."""
    return _dense_in(layer, x, torch.float32).to(layer.compute_dtype)


def quant_dense_exact(layer: QuantDense, x: torch.Tensor) -> torch.Tensor:
    """The same function in f64 and unrounded: the value that int8 and
    int4's per-group partials, which round once, must round to."""
    return _dense_in(layer, x, torch.float64)


#: the one-rounding limit of a bf16 output against ``quant_dense_exact``:
#: half a bf16 ulp of the value, plus this share of the row's rms for the
#: f32 sums' order (their error is far smaller; a bf16 product rounded
#: before the scale is off by up to 1.5 ulps)
ONE_ROUNDING_FLOOR = 2.0 ** -12


def one_rounding_share(got: torch.Tensor, exact: torch.Tensor) -> float:
    """The largest share of the one-rounding limit that the bf16 output
    ``got`` uses against ``exact``: at most 1 when ``got`` is ``exact``
    rounded once to bf16 (8 significant bits)."""
    e = exact.to(torch.float64)
    ulp = torch.ldexp(torch.ones_like(e), torch.frexp(e)[1] - 8)
    rms = e.pow(2).mean(dim=-1, keepdim=True).sqrt()
    lim = 0.5 * ulp + ONE_ROUNDING_FLOOR * rms
    return float(((got.to(torch.float64) - e).abs() / lim).max())


class QuantLoRADense(LoRADense):
    """A quantized frozen base under ``base`` and float adapters beside
    it (the QLoRA layout): ``lora_mask`` and the adapter files see the
    same keys as for ``LoRADense``."""

    def __init__(self, in_features: int, features: int, rank: int = 8,
                 alpha: float = 32.0, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, bits: int = 8,
                 group: int = 128, device=None,
                 param_dtype: torch.dtype = torch.float32,
                 dropout_in_training: bool = True):
        super().__init__(in_features, features, rank=rank, alpha=alpha,
                         dropout=dropout, device=device, dtype=param_dtype,
                         dropout_in_training=dropout_in_training,
                         base=QuantDense(in_features, features, dtype=dtype,
                                         bits=bits, group=group,
                                         device=device))

    def base_forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.base(x)


def quantize_kernel(w: torch.Tensor, bits: int = 8, group: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) float kernel -> (Q, scale) on ``w``'s device.

    bits=8: (in, out) int8 Q, (out,) f32 scale, |q| <= 127.
    bits=4: (in / 2, out) nibble-packed int8 Q, (G, out) f32 scale along
    the input dimension, |q| <= 7 (one code of [-8, 7] unused).
    The divisions are true f32 divisions (by a tensor: torch turns a
    division by a Python number into a reciprocal multiply on the card)
    and the rounding is half to even, as the JAX package's host path.
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    wf = w.to(torch.float32)
    n_in, n_out = wf.shape
    g = _num_groups(n_in, bits, group)
    qmax = 127.0 if bits == 8 else 7.0
    wg = wf.reshape(g, n_in // g, n_out)
    amax = wg.abs().amax(dim=1)                                # (g, out)
    scale = amax / torch.full_like(amax, qmax)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -qmax, qmax)
    q = q.reshape(n_in, n_out).to(torch.int8)
    if bits == 8:
        return q, scale[0]
    if (n_in // g) % 2:
        raise ValueError(f"packed int4 needs an even group size, got "
                         f"{n_in // g}")
    return pack_nibbles(q), scale


def is_quantized_weight(key: str) -> bool:
    """A LlavaTorch state_dict key that quantization replaces: the
    weight of a language-model projection or of ``lm_head`` (also under
    a LoRA ``base``), never one of the vision tower's."""
    parts = key.split(".")
    return (parts[-1] == "weight" and bool(set(parts) & set(LM_PROJ_NAMES))
            and "vision_tower" not in parts)


def _quantized_key(key: str) -> str:
    return key[:-len("weight")]


def quantize_llava_variables(state: Mapping[str, torch.Tensor],
                             bits: int = 8, group: int = 128
                             ) -> Dict[str, torch.Tensor]:
    """Replace every LM projection weight of a LlavaTorch state_dict by
    ``kernel_q`` and ``kernel_scale``; returns a new state_dict for
    ``LlavaTorchConfig(quantized=True, quant_bits=bits,
    quant_group=group)``. Each weight is quantized on its own device;
    vision, projector, embedding and norm leaves and the LoRA adapters
    pass through."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        if is_quantized_weight(k):
            q, s = quantize_kernel(v.T, bits, group)
            out[_quantized_key(k) + "kernel_q"] = q
            out[_quantized_key(k) + "kernel_scale"] = s
        else:
            out[k] = v
    return out


def quantize_llava_state_device(state_box: list, bits: int = 8
                                ) -> Dict[str, torch.Tensor]:
    """int8 ``quantize_llava_variables`` that CONSUMES its input: pass
    ``[state]`` (with no other reference to its tensors); the box is
    emptied and each weight is released as soon as its int8 replacement
    exists, so the device holds the input plus one kernel at most, never
    two models. int4 goes through ``quantize_llava_variables``."""
    if bits != 8:
        raise ValueError("device quantization supports bits=8 only; "
                         "use quantize_llava_variables for int4")
    if not isinstance(state_box, list) or len(state_box) != 1:
        raise ValueError("pass the state_dict in a 1-element list; it is "
                         "consumed (the box is emptied)")
    state = dict(state_box.pop())
    out: Dict[str, torch.Tensor] = {}
    for k in list(state):
        v = state.pop(k)
        if is_quantized_weight(k):
            q, s = quantize_kernel(v.T, 8)
            del v
            out[_quantized_key(k) + "kernel_q"] = q
            out[_quantized_key(k) + "kernel_scale"] = s
        else:
            out[k] = v
    return out


# the JAX package's name (vla/quant.py:249) for the same consuming int8
# quantizer; its "variables" are the port's state_dict
quantize_llava_variables_device = quantize_llava_state_device
