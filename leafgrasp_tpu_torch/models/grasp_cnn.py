"""GraspPointCNN in PyTorch, port of leafgrasp_tpu/models/grasp_cnn.py
(reference ml_grasp_optimizer/model.py:5-128): 9-channel 32x32 patches
-> Conv-BN-ReLU x2 + maxpool + dropout encoder blocks -> attention gate
-> global average pool -> BN-MLP classifier -> one logit.

The public input is the JAX package's NHWC (N, P, P, C) batch; the
convolutions run NCHW (``nn.Conv2d``, as the JAX package leaves its
convolutions to XLA), and the gate takes the (N, HW, C) layout of the
attention kernel (kernels/attention.py). Weights come from a Flax
checkpoint through ``models/convert.py`` or from a seed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from leafgrasp_tpu_torch.config import ModelConfig
from leafgrasp_tpu_torch.kernels.attention import fused_attention_gate

__all__ = ["GraspPointCNN", "AttentionGate", "ARCHITECTURES", "init_random_",
           "init_like_flax_", "batchnorm_fed_biases",
           "ml_scores_from_logits"]

# The 4 encoder architectures swept by the reference
# (mlflow_experiment_configs.py:84-116).
ARCHITECTURES = {
    "lightweight": (32, 64, 128),
    "standard": (64, 128, 256),
    "deep": (32, 64, 128, 256),
    "wide": (128, 256, 512),
}

# Flax's BatchNorm epsilon and momentum (ra = 0.99 ra + 0.01 stat)
BN_EPS = 1e-5
BN_MOMENTUM = 0.99


class _FlaxBatchNorm:
    """Train-mode statistics of ``flax.linen.BatchNorm``: the batch mean
    and the biased variance ``E[x^2] - E[x]^2`` (clipped at 0) normalize
    the batch and update the running averages with Flax's momentum. Eval
    mode is torch's, on the running statistics."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            for avg, stat in ((self.running_mean, mean),
                              (self.running_var, var)):
                avg.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM)
                                           * stat.detach())
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)


class EncoderBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, dropout: float):
        super().__init__()
        self.conv0 = nn.Conv2d(in_ch, filters, 3, padding=1)
        self.bn0 = BatchNorm2d(filters)
        self.conv1 = nn.Conv2d(filters, filters, 3, padding=1)
        self.bn1 = BatchNorm2d(filters)
        self.pool = nn.MaxPool2d(2, 2)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        x = torch.relu(self.bn0(self.conv0(x)))
        x = torch.relu(self.bn1(self.conv1(x)))
        return self.drop(self.pool(x))


class AttentionGate(nn.Module):
    """Spatial / channel (squeeze-excite) / hybrid / none gating with the
    Flax parameter layouts: spatial_kernel (C, 1), squeeze_kernel (C, R),
    excite_kernel (R, C). Unused gates are zero buffers."""

    def __init__(self, mode: str, channels: int, reduction: int = 16):
        super().__init__()
        if mode not in ("spatial", "channel", "hybrid", "none"):
            raise ValueError(f"unknown attention {mode!r}")
        self.mode = mode
        c, r = channels, max(channels // reduction, 1)
        spatial = mode in ("spatial", "hybrid")
        channel = mode in ("channel", "hybrid")

        def slot(name, shape, learned):
            t = torch.zeros(shape)
            if learned:
                setattr(self, name, nn.Parameter(t))
            else:
                self.register_buffer(name, t, persistent=False)

        slot("spatial_kernel", (c, 1), spatial)
        slot("spatial_bias", (1,), spatial)
        slot("squeeze_kernel", (c, r), channel)
        slot("squeeze_bias", (r,), channel)
        slot("excite_kernel", (r, c), channel)
        slot("excite_bias", (c,), channel)

    def forward(self, x):
        """x: (N, C, H, W) -> gated (N, C, H, W)."""
        if self.mode == "none":
            return x
        n, c, h, w = x.shape
        # the (N, HW, C) view of the NCHW activations, read through its
        # strides: no copy
        xs = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
        out = fused_attention_gate(
            xs, self.spatial_kernel, self.spatial_bias, self.squeeze_kernel,
            self.squeeze_bias, self.excite_kernel, self.excite_bias,
            self.mode)
        return out.reshape(n, h, w, c).permute(0, 3, 1, 2)


class GraspPointCNN(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        blocks, ch = [], cfg.in_channels
        for filters in cfg.encoder_filters:
            blocks.append(EncoderBlock(ch, filters, cfg.conv_dropout))
            ch = filters
        self.blocks = nn.ModuleList(blocks)
        self.attention = AttentionGate(cfg.attention_type, ch,
                                       cfg.se_reduction)
        widths = (ch, ch // 2, ch // 4)
        dense, bns, drops = [], [], []
        for width, drop in zip(widths, cfg.fc_dropout):
            dense.append(nn.Linear(ch, width))
            bns.append(BatchNorm1d(width))
            drops.append(nn.Dropout(drop))
            ch = width
        self.dense = nn.ModuleList(dense)
        self.dense_bn = nn.ModuleList(bns)
        self.dense_drop = nn.ModuleList(drops)
        self.head = nn.Linear(ch, 1)

    def forward(self, x):
        """x: (N, P, P, C) NHWC float32 -> (N, 1) logits."""
        x = x.permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x)
        x = self.attention(x)
        x = x.mean(dim=(2, 3))                                # GAP
        for lin, bn, drop in zip(self.dense, self.dense_bn, self.dense_drop):
            x = drop(torch.relu(bn(lin(x))))
        return self.head(x)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def init_random_(model: GraspPointCNN, seed: int = 0) -> GraspPointCNN:
    """Seeded weights from numpy (Kaiming-scaled normals, small random
    biases and BatchNorm statistics), for runs without a checkpoint."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            shape = tuple(t.shape)
            if name.endswith("running_var"):
                val = rng.uniform(0.5, 1.5, shape)
            elif name.endswith("running_mean") or name.endswith("bias"):
                val = rng.normal(0.0, 0.05, shape)
            elif len(shape) >= 2:
                fan_in = int(np.prod(shape[1:])) if len(shape) == 4 \
                    else shape[0] if "kernel" in name else shape[1]
                val = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
            else:
                val = rng.uniform(0.8, 1.2, shape)
            t.copy_(torch.as_tensor(val, dtype=t.dtype))
    return model


def batchnorm_fed_biases(model: GraspPointCNN) -> tuple:
    """Names of the biases that feed a BatchNorm (every convolution's and
    every dense layer's but the head's). In train mode the batch mean
    cancels them: their exact gradient is 0, and a computed one is
    rounding noise."""
    return tuple(f"{name}.bias" for name, mod in model.named_modules()
                 if isinstance(mod, (nn.Conv2d, nn.Linear))
                 and name != "head")


# Flax's variance_scaling(..., "truncated_normal"): a normal cut at two
# standard deviations, widened so that the cut one has the asked variance
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(t: torch.Tensor, scale: float, fan: int,
                   generator: torch.Generator) -> None:
    std = float(np.sqrt(scale / fan)) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_like_flax_(model: GraspPointCNN,
                    generator: torch.Generator) -> GraspPointCNN:
    """Initial weights with the Flax model's schemes
    (leafgrasp_tpu/models/grasp_cnn.py:37-46): convolutions truncated
    normal, variance 2 / fan-out (kh kw out); dense layers 2 / fan-in;
    the attention gate's kernels 1 / fan-in (LeCun, their first axis);
    zero biases; BatchNorm scale 1, bias 0, mean 0, variance 1. Draws
    from ``generator`` (a CPU generator gives the same weights for any
    device the model is moved to afterwards)."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            o, _, kh, kw = mod.weight.shape
            _trunc_normal_(mod.weight, 2.0, kh * kw * o, generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            _trunc_normal_(mod.weight, 2.0, mod.weight.shape[1], generator)
            mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
            mod.reset_running_stats()
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, AttentionGate):
            for name, p in mod.named_parameters(recurse=False):
                if name.endswith("kernel"):
                    _trunc_normal_(p, 1.0, p.shape[0], generator)
                else:
                    p.zero_()
    return model


def ml_scores_from_logits(logits: torch.Tensor,
                          spread_scale: float = 3.0) -> torch.Tensor:
    """sigmoid -> tanh spread, as served (grasp_point_selector.py:133-136)."""
    s = torch.sigmoid(logits.reshape(-1))
    return torch.tanh(s * spread_scale) * 0.5 + 0.5
