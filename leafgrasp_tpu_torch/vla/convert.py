"""The JAX package's VLA variables -> the port's ``state_dict``s.

Takes Flax variables as nested dicts of numpy arrays (``{"params":
...}`` or the params tree itself), or the flat ``"a/b/c"`` keyed dicts
that the ``.npz`` files under ``artifacts/vla`` hold, and renames and
transposes: Dense kernels (in, out) -> (out, in), convolution kernels
(kh, kw, in, out) -> (out, in, kh, kw), LayerNorm ``scale`` ->
``weight``; embeddings, RMSNorm weights, ``lora_a`` / ``lora_b``,
``image_newline`` and the quantized layers' ``kernel_q`` (int8, or int4
nibble-packed) and ``kernel_scale`` keep the JAX orientation. Reads no
files itself and imports neither JAX nor Flax.

The other way, ``torch_to_flax_tiny_vla``, ``torch_to_flax_llava`` and
``torch_to_flax_llava_adapter`` give the flat ``"a/b/c"`` keys and
orientation of the JAX package's ``.npz`` files
(``flax.traverse_util.flatten_dict`` joined by ``/``): what the JAX
trainers' ``save_adapter`` and ``run_vla_sweep``'s ``pretrained_base.npz``
hold, so that either package loads the other's. ``llava_flax_name`` is
the key map alone, which the tensor-parallel rule reads
(``parallel/sharding.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from leafgrasp_tpu_torch.vla.quant import pack_nibbles

__all__ = ["unflatten_tree", "flax_to_torch_tiny_vla",
           "flax_to_torch_llava", "torch_to_flax_tiny_vla",
           "torch_to_flax_llava", "llava_flax_name",
           "torch_to_flax_llava_adapter"]


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    """``{"a/b/c": array}`` (an ``.npz`` file's mapping) -> nested dicts."""
    out: Dict = {}
    for key in flat.keys():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(flat[key])
    return out


def _params(variables) -> Mapping:
    if not isinstance(variables, Mapping) or \
            any("/" in str(k) for k in variables.keys()):
        variables = unflatten_tree(variables)
    return variables.get("params", variables)


def _quant_codes(kernel_q, kernel_scale) -> torch.Tensor:
    """A QuantDense's ``kernel_q`` in the port's layout: int8 (in, out) as
    it is; int4 as (in / 2, out) nibble-packed int8, which the JAX
    package's packed storage already is and its native ``jnp.int4``
    (in, out) gets packed into. int4 has a 2-D scale (G, out)."""
    q = np.asarray(kernel_q)
    if q.dtype.name == "int4":
        return pack_nibbles(torch.as_tensor(q.astype(np.int8)))
    if q.dtype != np.int8 or np.ndim(kernel_scale) not in (1, 2):
        raise TypeError(f"kernel_q of type {q.dtype}, scale of rank "
                        f"{np.ndim(kernel_scale)}: not a QuantDense kernel")
    return _t(q)


def _dense(out: dict, prefix: str, node: Mapping) -> None:
    """A Dense (``kernel`` [+ ``bias``]), a QuantDense (``kernel_q``,
    ``kernel_scale``) or a LoRADense / QuantLoRADense (the same under
    ``base`` [+ ``lora_a``, ``lora_b``]); missing leaves are left out."""
    if "base" in node:
        _dense(out, f"{prefix}.base", node["base"])
    if "kernel" in node:
        out[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).T)
    if "kernel_q" in node:
        out[f"{prefix}.kernel_q"] = _quant_codes(node["kernel_q"],
                                                 node["kernel_scale"])
        out[f"{prefix}.kernel_scale"] = _t(node["kernel_scale"])
    if "bias" in node:
        out[f"{prefix}.bias"] = _t(node["bias"])
    for leaf in ("lora_a", "lora_b"):
        if leaf in node:
            out[f"{prefix}.{leaf}"] = _t(node[leaf])


def _conv(out: dict, prefix: str, node: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(
        np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
    if "bias" in node:
        out[f"{prefix}.bias"] = _t(node["bias"])


def _layer_norm(out: dict, prefix: str, node: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(node["scale"])
    out[f"{prefix}.bias"] = _t(node["bias"])


def flax_to_torch_tiny_vla(variables) -> Dict[str, torch.Tensor]:
    """TinyVLA variables -> ``TinyVLA.state_dict()`` entries (whatever
    the tree holds: a full model, a pretrained base, or an adapter)."""
    p = _params(variables)
    out: Dict[str, torch.Tensor] = {}
    for name, node in p.items():
        if name == "tok_emb":
            out["tok_emb.weight"] = _t(node["embedding"])
        elif name == "final_norm":
            out["final_norm.scale"] = _t(node["scale"])
        elif name == "lm_head":
            _dense(out, "lm_head", node)
        elif name == "vision":
            for sub, leaf in node.items():
                if sub.startswith("Conv_"):
                    _conv(out, f"vision.convs.{sub[5:]}", leaf)
                else:
                    _dense(out, "vision.proj", leaf)
        elif name.startswith("layer_"):
            dst = f"layers.{name[6:]}"
            for sub, leaf in node.items():
                if sub.endswith("_norm"):
                    out[f"{dst}.{sub}.scale"] = _t(leaf["scale"])
                else:                      # attn / mlp
                    for pr, pnode in leaf.items():
                        _dense(out, f"{dst}.{sub}.{pr}", pnode)
        else:
            raise KeyError(f"unknown TinyVLA subtree {name!r}")
    return out


def flax_to_torch_llava(variables) -> Dict[str, torch.Tensor]:
    """LlavaJax variables -> ``LlavaTorch.state_dict()`` entries
    (whatever the tree holds: a full model, or adapter leaves only)."""
    p = _params(variables)
    out: Dict[str, torch.Tensor] = {}
    for name, node in p.items():
        if name == "vision_tower":
            for sub, leaf in node.items():
                dst = f"vision_tower.{sub}"
                if sub in ("class_embedding", "position_embedding"):
                    out[dst] = _t(leaf)
                elif sub == "patch_embedding":
                    _conv(out, dst, leaf)
                elif sub == "pre_layrnorm":
                    _layer_norm(out, dst, leaf)
                else:                      # layer_i
                    dst = f"vision_tower.layers.{sub[6:]}"
                    for part, pnode in leaf.items():
                        if part.startswith("layer_norm"):
                            _layer_norm(out, f"{dst}.{part}", pnode)
                        elif part == "self_attn":
                            for pr, q in pnode.items():
                                _dense(out, f"{dst}.self_attn.{pr}", q)
                        else:              # fc1 / fc2
                            _dense(out, f"{dst}.{part}", pnode)
        elif name in ("mm_linear_1", "mm_linear_2", "lm_head"):
            _dense(out, name, node)
        elif name == "embed_tokens":
            out["embed_tokens.weight"] = _t(node["embedding"])
        elif name == "norm":
            out["norm.weight"] = _t(node["weight"])
        elif name == "image_newline":
            out["image_newline"] = _t(node)
        elif name.startswith("layer_"):
            dst = f"layers.{name[6:]}"
            for part, pnode in node.items():
                if part.endswith("layernorm"):
                    out[f"{dst}.{part}.weight"] = _t(pnode["weight"])
                elif part == "self_attn":
                    for pr, q in pnode.items():
                        _dense(out, f"{dst}.self_attn.{pr}", q)
                else:                      # gate / up / down
                    _dense(out, f"{dst}.{part}", pnode)
        else:
            raise KeyError(f"unknown LlavaJax subtree {name!r}")
    return out


# ------------------------------------------------------ the other way --

def _np(x) -> np.ndarray:
    return x.detach().to("cpu").numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _leaf_to_flax(parts: list, value) -> tuple:
    """The last part of a ``state_dict`` key and its value -> the Flax
    leaf name and array: a Linear's ``weight`` is the transposed
    ``kernel``, a convolution's (out, in, kh, kw) becomes (kh, kw, in,
    out); norm scales, biases and adapters go as they are."""
    leaf, a = parts[-1], _np(value)
    if leaf == "weight":
        return "kernel", (np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4
                          else a.T)
    return leaf, a


def torch_to_flax_tiny_vla(state: Mapping[str, torch.Tensor]
                           ) -> Dict[str, np.ndarray]:
    """``TinyVLA.state_dict()`` entries (a full model, a pretrained base
    or an adapter) -> the flat Flax keys of its variables' params."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        parts = key.split(".")
        if key == "tok_emb.weight":
            out["tok_emb/embedding"] = _np(value)
            continue
        if parts[0] == "vision":
            if parts[1] == "convs":             # vision.convs.i.leaf
                path = ["vision", f"Conv_{parts[2]}"]
            else:                               # vision.proj.leaf
                path = ["vision", "Dense_0"]
        elif parts[0] == "layers":              # layers.i.sub[.proj...]
            path = [f"layer_{parts[1]}", *parts[2:-1]]
        elif parts[0] in ("final_norm", "lm_head"):
            path = parts[:-1]
        else:
            raise KeyError(f"unknown TinyVLA entry {key!r}")
        leaf, a = _leaf_to_flax(parts, value)
        out["/".join(path + [leaf])] = a
    return out


# a ``weight`` leaf -> its Flax leaf, by the module that holds it: the
# LayerNorms' scale, the embedding table, the RMSNorms' weight; a kernel
# everywhere else
_LAYER_NORMS = ("pre_layrnorm", "layer_norm1", "layer_norm2")
_RMS_NORMS = ("input_layernorm", "post_attention_layernorm", "norm")


def llava_flax_name(key: str) -> str:
    """A ``LlavaTorch.state_dict()`` key -> the flat Flax path of the same
    variable in ``LlavaJax``: ``layers.3.self_attn.q_proj.base.weight`` ->
    ``layer_3/self_attn/q_proj/base/kernel``,
    ``vision_tower.layers.0.layer_norm1.weight`` ->
    ``vision_tower/layer_0/layer_norm1/scale``; plain, LoRA (``base``,
    ``lora_a``, ``lora_b``) and quantized (``kernel_q``,
    ``kernel_scale``) keys alike."""
    parts = key.split(".")
    path = []
    i = 0
    while i < len(parts) - 1:
        if parts[i] == "layers":
            path.append(f"layer_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    leaf = parts[-1]
    if leaf == "weight":
        owner = path[-1]
        leaf = ("scale" if owner in _LAYER_NORMS
                else "embedding" if owner == "embed_tokens"
                else "weight" if owner in _RMS_NORMS else "kernel")
    return "/".join(path + [leaf])


def torch_to_flax_llava(state: Mapping[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    """``LlavaTorch.state_dict()`` entries -> the flat Flax keys of
    ``LlavaJax``'s params, kernels in the Flax orientation (the inverse
    of ``flax_to_torch_llava``; int4 codes stay nibble-packed)."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        name = llava_flax_name(key)
        a = _np(value)
        if name.endswith("/kernel"):
            a = np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T
        out[name] = a
    return out


def torch_to_flax_llava_adapter(state: Mapping[str, torch.Tensor]
                                ) -> Dict[str, np.ndarray]:
    """The adapter leaves of a ``LlavaTorch.state_dict()`` -> the flat
    Flax keys of ``LlavaJax`` (``layer_i/self_attn/q_proj/lora_a``,
    ``layer_i/gate_proj/lora_b``, ...); anything else raises."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        parts = key.split(".")
        if parts[0] != "layers" or parts[-1] not in ("lora_a", "lora_b"):
            raise KeyError(f"not an adapter leaf of LlavaTorch: {key!r}")
        out["/".join([f"layer_{parts[1]}", *parts[2:]])] = _np(value)
    return out
