"""LLaVA checkpoint IO without transformers: the port of
leafgrasp_tpu/vla/checkpoint_io.py.

The reference serving node loads its 7B VLM through the transformers
pipeline. The port reads the same on-disk HuggingFace checkpoint layout
itself:

- ``read_safetensors`` / ``write_safetensors``: the safetensors container
  (8-byte little-endian header length, JSON header, raw little-endian
  tensor bytes) as CPU tensors, bf16 as ``torch.bfloat16``. Files are
  written byte for byte as the JAX package writes them (header in the
  order given, no padding).
- ``SentencePieceTokenizer``: a pure-Python reader of the
  ``tokenizer.model`` protobuf (sentencepiece ``ModelProto``) with BPE
  merges and unigram Viterbi, byte fallback and the Llama/Mistral
  dummy-prefix and whitespace conventions; ``write_sentencepiece_model``
  writes one.
- ``load_llava_checkpoint``: checkpoint directory (config.json +
  model.safetensors[.index.json] + tokenizer.model) -> (LlavaTorch on its
  device, its state dict, tokenizer), for ``LlavaTorchScorer``.

Only the protobuf fields sentencepiece_model.proto assigns to
ModelProto (1 pieces, 2 trainer_spec, 3 normalizer_spec), SentencePiece
(1 piece, 2 score, 3 type), TrainerSpec (3 model_type, 35 byte_fallback,
40-43 unk/bos/eos/pad ids) and NormalizerSpec (3 add_dummy_prefix) are
read.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import struct
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

__all__ = [
    "read_safetensors", "write_safetensors", "SentencePieceTokenizer",
    "write_sentencepiece_model", "load_llava_checkpoint",
    "parse_llava_config", "DictConfig", "write_synthetic_llava_checkpoint",
]


# --------------------------------------------------------- safetensors --

_ST_DTYPES: Dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def _read_header(path: str) -> Tuple[Dict[str, Any], int]:
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(hlen).decode("utf-8")), 8 + hlen


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One .safetensors file -> name -> CPU tensor, in file order.

    The tensors are views of a copy-on-write mmap of the file (each holds
    a reference to it), so a 14 GB checkpoint is never read into memory
    twice; copies happen only where the caller casts or moves them."""
    header, base = _read_header(path)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out: Dict[str, torch.Tensor] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[spec["dtype"]]
        b, e = spec["data_offsets"]
        n = (e - b) // torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(mm, dtype=dtype, count=n, offset=base + b) \
            if n else torch.empty((0,), dtype=dtype)
        out[name] = t.reshape(spec["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, Any],
                      metadata: Dict[str, str] | None = None) -> None:
    """Write name -> tensor (or numpy array) as a .safetensors file."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = metadata
    blobs: List[torch.Tensor] = []
    off = 0
    for name, arr in tensors.items():
        t = torch.as_tensor(arr).detach().to("cpu").contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + nbytes]}
        blobs.append(t)
        off += nbytes
    hjson = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for t in blobs:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def _shard_files(path: str) -> List[str]:
    """A checkpoint directory's safetensors files (one, or the shards of
    its index in sorted order)."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map: Dict[str, str] = json.load(f)["weight_map"]
        return [os.path.join(path, s)
                for s in sorted(set(weight_map.values()))]
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return [single]
    raise FileNotFoundError(
        f"no model.safetensors[.index.json] under {path}")


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Checkpoint dir -> merged state_dict (single file or shard index)."""
    sd: Dict[str, torch.Tensor] = {}
    for shard in _shard_files(path):
        sd.update(read_safetensors(shard))
    return sd


# ------------------------------------------------- minimal protobuf IO --

def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    val = shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:                      # varint
            val, i = _varint(buf, i)
        elif wire == 1:                    # fixed64
            val = buf[i:i + 8]
            i += 8
        elif wire == 2:                    # length-delimited
            n, i = _varint(buf, i)
            val = buf[i:i + n]
            i += n
        elif wire == 5:                    # fixed32
            val = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _emit_i32(val: int) -> bytes:
    """protobuf int32: negatives are encoded as 64-bit two's-complement
    varints (10 bytes), as the sentencepiece runtime writes them."""
    return _emit_varint(val & 0xFFFFFFFFFFFFFFFF if val < 0 else val)


def _emit_varint(val: int) -> bytes:
    out = bytearray()
    while True:
        b = val & 0x7F
        val >>= 7
        if val:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _emit_field(field: int, wire: int, payload: bytes) -> bytes:
    head = _emit_varint((field << 3) | wire)
    if wire == 2:
        return head + _emit_varint(len(payload)) + payload
    return head + payload


def write_sentencepiece_model(
        path: str, pieces: List[Tuple[str, float, int]],
        model_type: str = "bpe", add_dummy_prefix: bool = True,
        byte_fallback: bool = True, unk_id: int = 0, bos_id: int = 1,
        eos_id: int = 2, pad_id: int = -1) -> None:
    """Serialize a minimal sentencepiece ModelProto (for tests and tools).

    pieces: [(piece, score, type)] with type in {1 NORMAL, 2 UNKNOWN,
    3 CONTROL, 4 USER_DEFINED, 6 BYTE}.
    """
    body = bytearray()
    for piece, score, ptype in pieces:
        sp = (_emit_field(1, 2, piece.encode("utf-8"))
              + _emit_field(2, 5, struct.pack("<f", score))
              + _emit_field(3, 0, _emit_varint(ptype)))
        body += _emit_field(1, 2, sp)
    mt = {"unigram": 1, "bpe": 2}[model_type]
    trainer = (_emit_field(3, 0, _emit_varint(mt))
               + _emit_field(35, 0, _emit_varint(int(byte_fallback)))
               + _emit_field(40, 0, _emit_i32(unk_id))
               + _emit_field(41, 0, _emit_i32(bos_id))
               + _emit_field(42, 0, _emit_i32(eos_id))
               + _emit_field(43, 0, _emit_i32(pad_id)))
    body += _emit_field(2, 2, trainer)
    norm = _emit_field(3, 0, _emit_varint(int(add_dummy_prefix)))
    body += _emit_field(3, 2, norm)
    with open(path, "wb") as f:
        f.write(bytes(body))


_SPACE = "▁"        # the sentencepiece whitespace escape
_UNK_PENALTY = 10.0      # sentencepiece unigram_model.cc kUnkPenalty


def _i32(v: int) -> int:
    """A protobuf int32 read as a varint: negatives arrive as 64-bit
    two's-complement values (pad_id -1 in Llama/Mistral tokenizer.model
    files is wire value 2^64 - 1); keep the low 32 bits, signed."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


class SentencePieceTokenizer:
    """Pure-Python sentencepiece inference from a tokenizer.model file.

    The two model types in use (BPE: Llama/Mistral; unigram: T5-family),
    byte fallback, and the standard normalizer conventions (whitespace
    escaped to U+2581, optional dummy prefix). What ``LlavaTorchScorer``
    needs: encode(text) -> List[int], decode(ids) -> str, and the
    bos/eos/unk/pad ids.
    """

    def __init__(self, model_path: str):
        with open(model_path, "rb") as f:
            buf = f.read()
        self.pieces: List[str] = []
        self.scores: List[float] = []
        self.types: List[int] = []
        self.model_type = 2            # BPE default
        self.byte_fallback = False
        self.add_dummy_prefix = True
        self.unk_id, self.bos_id, self.eos_id, self.pad_id = 0, 1, 2, -1

        for field, wire, val in _fields(buf):
            if field == 1 and wire == 2:           # SentencePiece
                piece, score, ptype = "", 0.0, 1
                for f2, _w2, v2 in _fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        (score,) = struct.unpack("<f", v2)
                    elif f2 == 3:
                        ptype = v2
                self.pieces.append(piece)
                self.scores.append(score)
                self.types.append(ptype)
            elif field == 2 and wire == 2:         # TrainerSpec
                for f2, _w2, v2 in _fields(val):
                    if f2 == 3:
                        self.model_type = v2
                    elif f2 == 35:
                        self.byte_fallback = bool(v2)
                    elif f2 == 40:
                        self.unk_id = _i32(v2)
                    elif f2 == 41:
                        self.bos_id = _i32(v2)
                    elif f2 == 42:
                        self.eos_id = _i32(v2)
                    elif f2 == 43:
                        self.pad_id = _i32(v2)
            elif field == 3 and wire == 2:         # NormalizerSpec
                for f2, _w2, v2 in _fields(val):
                    if f2 == 3:
                        self.add_dummy_prefix = bool(v2)

        self.vocab: Dict[str, int] = {}
        for i, p in enumerate(self.pieces):
            self.vocab.setdefault(p, i)
        # an UNKNOWN-typed piece overrides the trainer's unk_id
        for i, t in enumerate(self.types):
            if t == 2:
                self.unk_id = i
                break

    def __len__(self) -> int:
        return len(self.pieces)

    # ---- encoding ---------------------------------------------------

    def _byte_ids(self, ch: str) -> List[int] | None:
        ids = []
        for b in ch.encode("utf-8"):
            i = self.vocab.get(f"<0x{b:02X}>")
            if i is None:
                return None
            ids.append(i)
        return ids

    def _tokenize_bpe(self, text: str) -> List[int]:
        """sentencepiece BPE: repeatedly merge the adjacent pair whose
        concatenation is a vocab piece with the best (max) score; ties
        go to the leftmost pair (bpe_model.cc's agenda order)."""
        syms = list(text)
        if not syms:
            return []
        while len(syms) > 1:
            best_score, best_i = None, -1
            for i in range(len(syms) - 1):
                j = self.vocab.get(syms[i] + syms[i + 1])
                if j is None:
                    continue
                s = self.scores[j]
                if best_score is None or s > best_score:
                    best_score, best_i = s, i
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        out: List[int] = []
        for s in syms:
            j = self.vocab.get(s)
            if j is not None:
                out.append(j)
                continue
            bids = self._byte_ids(s) if self.byte_fallback else None
            out.extend(bids if bids is not None else [self.unk_id])
        return out

    def _tokenize_unigram(self, text: str) -> List[int]:
        """Viterbi segmentation maximizing the summed piece log-probs,
        with sentencepiece's unk penalty for single unknown characters."""
        n = len(text)
        if n == 0:
            return []
        unk_score = min(self.scores) - _UNK_PENALTY if self.scores \
            else -_UNK_PENALTY
        best = [(-np.inf, -1, -1)] * (n + 1)   # (score, prev, piece_id)
        best[0] = (0.0, -1, -1)
        maxlen = max((len(p) for p in self.pieces), default=1)
        for e in range(1, n + 1):
            for s in range(max(0, e - maxlen), e):
                if best[s][0] == -np.inf:
                    continue
                sub = text[s:e]
                j = self.vocab.get(sub)
                if j is not None:
                    sc = best[s][0] + self.scores[j]
                    if sc > best[e][0]:
                        best[e] = (sc, s, j)
                if e - s == 1 and j is None:
                    sc = best[s][0] + unk_score
                    if sc > best[e][0]:
                        best[e] = (sc, s, -1)
        ids: List[int] = []
        e = n
        while e > 0:
            _, s, j = best[e]
            if j >= 0:
                ids.append(j)
            else:
                ch = text[s:e]
                bids = self._byte_ids(ch) if self.byte_fallback else None
                if bids is not None:
                    ids.extend(reversed(bids))
                else:
                    ids.append(self.unk_id)
            e = s
        return ids[::-1]

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        t = text
        # sentencepiece leaves the empty sentence empty: no dummy prefix
        if t and self.add_dummy_prefix and not t.startswith(" "):
            t = " " + t
        t = t.replace(" ", _SPACE)
        ids = (self._tokenize_bpe(t) if self.model_type == 2
               else self._tokenize_unigram(t))
        if add_bos and self.bos_id >= 0:
            ids = [self.bos_id] + ids
        if add_eos and self.eos_id >= 0:
            ids = ids + [self.eos_id]
        return ids

    # ---- decoding ---------------------------------------------------

    def decode(self, ids) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.pieces):
                continue
            if self.types[i] == 6:                   # BYTE piece <0xXX>
                byte_buf.append(int(self.pieces[i][3:5], 16))
                continue
            flush()
            if self.types[i] in (2, 3):              # UNK / CONTROL
                continue
            out.append(self.pieces[i])
        flush()
        text = "".join(out).replace(_SPACE, " ")
        if self.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text


# ------------------------------------------------------ config loading --

class DictConfig:
    """Attribute view over a JSON config dict (stands in for the HF config
    object that ``config_from_hf`` reads)."""

    def __init__(self, d: Dict[str, Any]):
        self._d = d

    def __getattr__(self, name: str):
        try:
            v = self._d[name]
        except KeyError:
            raise AttributeError(name) from None
        return DictConfig(v) if isinstance(v, dict) else v


# CLIP-vision / Mistral defaults for fields HF config.json may omit
_VISION_DEFAULTS = {
    "hidden_size": 768, "intermediate_size": 3072,
    "num_hidden_layers": 12, "num_attention_heads": 12,
    "image_size": 224, "patch_size": 32,
}
_TEXT_DEFAULTS = {
    "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "sliding_window": None,
}


def parse_llava_config(raw: Dict[str, Any]):
    """config.json dict -> LlavaTorchConfig, with defaults for the fields
    HF omits: the parsing ``load_llava_checkpoint`` uses."""
    from leafgrasp_tpu_torch.vla.llava_torch import config_from_hf
    raw = dict(raw)
    raw["vision_config"] = {**_VISION_DEFAULTS,
                            **raw.get("vision_config", {})}
    tc = {**_TEXT_DEFAULTS, **raw.get("text_config", {})}
    tc.setdefault("num_key_value_heads", tc.get("num_attention_heads"))
    raw["text_config"] = tc
    return config_from_hf(DictConfig(raw))


# ---------------------------------------------------------- the loader --

def _hf_name_map(cfg, names) -> Dict[str, str]:
    """HF checkpoint name -> LlavaTorch state_dict name: the renaming of
    ``convert_hf_llava_state_dict`` run over the names themselves."""
    from leafgrasp_tpu_torch.vla.llava_torch import \
        convert_hf_llava_state_dict
    renamed = convert_hf_llava_state_dict({n: n for n in names}, cfg)
    return {src: dst for dst, src in renamed.items()}


def load_llava_checkpoint(path: str, lora_rank: int = 0,
                          dtype: str = "float32", quantize: bool = False,
                          quant_bits: int = 8, quant_group: int = 128,
                          device=None):
    """Checkpoint dir -> (LlavaTorch, its state_dict, tokenizer); no
    transformers.

    The model holds the weights on ``device`` (None means CUDA, and raises
    without it). Tensors go there one at a time from the mmapped shards,
    so host memory holds about one shard and the device the model plus
    one tensor.

    dtype: "float32" | "bfloat16", the type every floating-point weight is
    cast to; the compute type stays the config's ("float32"), as in the
    JAX package. quantize: every LM projection and ``lm_head`` becomes a
    weight-only quantized layer (vla/quant.py), quantized on ``device``
    from the cast weight with the host quantizer's arithmetic (the same
    codes and scales): per-channel int8 (``quant_bits=8``) or group-wise
    int4 (``quant_bits=4``, ``quant_group`` input rows a scale). With
    ``lora_rank > 0`` the projections get f32 adapters (``lora_a`` normal
    with std 1 / rank, ``lora_b`` zero) over the frozen base, quantized or
    not (the QLoRA layout).

    Tokenizer: ``tokenizer.model`` (the pure-Python sentencepiece reader);
    a directory with only ``tokenizer.json`` needs the ``tokenizers``
    package and raises ``ImportError`` naming it when it is missing.
    """
    from leafgrasp_tpu_torch.utils.device import resolve_device
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorch
    from leafgrasp_tpu_torch.vla.quant import (is_quantized_weight,
                                               quantize_kernel)

    dev = resolve_device(device)
    cast = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    with open(os.path.join(path, "config.json")) as f:
        cfg = parse_llava_config(json.load(f))
    changes: Dict[str, Any] = {"lora_rank": lora_rank}
    if quantize:
        if quant_bits not in (8, 4):
            raise ValueError(f"quant_bits must be 8 or 4, got {quant_bits}")
        changes.update(quantized=True, quant_bits=quant_bits,
                       quant_group=quant_group)
    cfg = dataclasses.replace(cfg, **changes)
    tokenizer = _load_tokenizer(path)

    shards = _shard_files(path)
    names = [n for s in shards for n in _read_header(s)[0]
             if n != "__metadata__"]
    rename = _hf_name_map(cfg, names)
    state: Dict[str, torch.Tensor] = {}
    for shard in shards:
        for src, t in read_safetensors(shard).items():
            dst = rename.get(src)
            if dst is None:
                continue                 # not a LlavaTorch weight
            t = t.to(dev)
            if t.is_floating_point():
                t = t.to(cast)
            if quantize and is_quantized_weight(dst):
                q, s = quantize_kernel(t.T, cfg.quant_bits, cfg.quant_group)
                stem = dst[:-len("weight")]
                state[stem + "kernel_q"] = q
                state[stem + "kernel_scale"] = s
            else:
                state[dst] = t
            del t
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = LlavaTorch.from_state(cfg, state, generator=gen)
    return model, model.state_dict(), tokenizer


# ------------------------------------- synthetic checkpoints (tests) --

def _hf_shapes(cfg):
    """(HF checkpoint name, shape) of every tensor of a LLaVA(-NeXT) model
    with ``cfg``'s widths, in the order of a HF state_dict."""
    v, d = cfg.vis_hidden, cfg.hidden
    kv = cfg.kv_heads * cfg.head_dim
    vt = "vision_tower.vision_model"
    out = [(f"{vt}.embeddings.class_embedding", (v,)),
           (f"{vt}.embeddings.position_embedding.weight",
            (cfg.num_patches + 1, v)),
           (f"{vt}.embeddings.patch_embedding.weight",
            (v, 3, cfg.patch_size, cfg.patch_size)),
           (f"{vt}.pre_layrnorm.weight", (v,)),
           (f"{vt}.pre_layrnorm.bias", (v,))]
    for i in range(cfg.vis_layers):
        li = f"{vt}.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            out += [(f"{li}.{ln}.weight", (v,)), (f"{li}.{ln}.bias", (v,))]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(f"{li}.self_attn.{proj}.weight", (v, v)),
                    (f"{li}.self_attn.{proj}.bias", (v,))]
        out += [(f"{li}.mlp.fc1.weight", (cfg.vis_intermediate, v)),
                (f"{li}.mlp.fc1.bias", (cfg.vis_intermediate,)),
                (f"{li}.mlp.fc2.weight", (v, cfg.vis_intermediate)),
                (f"{li}.mlp.fc2.bias", (v,))]
    out += [("multi_modal_projector.linear_1.weight", (d, v)),
            ("multi_modal_projector.linear_1.bias", (d,)),
            ("multi_modal_projector.linear_2.weight", (d, d)),
            ("multi_modal_projector.linear_2.bias", (d,))]
    if cfg.image_grid_pinpoints:
        out.append(("image_newline", (d,)))
    lm = "language_model.model"
    out.append((f"{lm}.embed_tokens.weight", (cfg.vocab_size, d)))
    for i in range(cfg.layers):
        li = f"{lm}.layers.{i}"
        out += [(f"{li}.input_layernorm.weight", (d,)),
                (f"{li}.post_attention_layernorm.weight", (d,)),
                (f"{li}.self_attn.q_proj.weight", (cfg.heads * cfg.head_dim,
                                                   d)),
                (f"{li}.self_attn.k_proj.weight", (kv, d)),
                (f"{li}.self_attn.v_proj.weight", (kv, d)),
                (f"{li}.self_attn.o_proj.weight", (d, cfg.heads
                                                   * cfg.head_dim)),
                (f"{li}.mlp.gate_proj.weight", (cfg.intermediate, d)),
                (f"{li}.mlp.up_proj.weight", (cfg.intermediate, d)),
                (f"{li}.mlp.down_proj.weight", (d, cfg.intermediate))]
    out += [(f"{lm}.norm.weight", (d,)), ("lm_head.weight",
                                          (cfg.vocab_size, d))]
    return out


def _hf_config(cfg) -> Dict[str, Any]:
    raw = {
        "architectures": ["LlavaNextForConditionalGeneration"
                          if cfg.image_grid_pinpoints
                          else "LlavaForConditionalGeneration"],
        "image_token_index": cfg.image_token_index,
        "vision_feature_layer": cfg.vision_feature_layer,
        "vision_feature_select_strategy": ("default" if cfg.drop_cls_token
                                           else "full"),
        "vision_config": {
            "hidden_size": cfg.vis_hidden,
            "intermediate_size": cfg.vis_intermediate,
            "num_hidden_layers": cfg.vis_layers,
            "num_attention_heads": cfg.vis_heads,
            "image_size": cfg.image_size, "patch_size": cfg.patch_size},
        "text_config": {
            "model_type": "mistral", "hidden_size": cfg.hidden,
            "intermediate_size": cfg.intermediate,
            "num_hidden_layers": cfg.layers,
            "num_attention_heads": cfg.heads,
            "num_key_value_heads": cfg.kv_heads,
            "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.rms_eps,
            "rope_theta": cfg.rope_theta,
            "sliding_window": cfg.sliding_window},
    }
    if cfg.image_grid_pinpoints:
        raw["image_grid_pinpoints"] = [list(p)
                                       for p in cfg.image_grid_pinpoints]
    return raw


def write_synthetic_llava_checkpoint(path: str, cfg, seed: int = 0,
                                     n_shards: int = 1) -> int:
    """Write a HF-layout checkpoint directory for ``cfg``'s widths with
    seeded random weights (for tests and smoke runs; no published
    checkpoint is in the repository): config.json, ``n_shards``
    safetensors files (tensor j in shard j mod n_shards) with their index,
    and a byte-fallback BPE tokenizer.model over lower-case letters,
    digits and punctuation. Weights are ``0.02 * normal`` from
    ``np.random.default_rng(seed)`` in bf16; norm gains are
    ``1 + 0.02 * normal`` and biases zero. Host memory holds one shard.
    Returns the bytes written."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_hf_config(cfg), f)
    rng = np.random.default_rng(seed)
    shapes = _hf_shapes(cfg)
    names = [f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"
             for s in range(n_shards)]
    weight_map = {name: names[j % n_shards]
                  for j, (name, _) in enumerate(shapes)}
    total = 0
    for s, shard in enumerate(names):
        tensors = {}
        for j, (name, shape) in enumerate(shapes):
            if j % n_shards != s:
                continue
            if name.endswith(".bias"):
                a = np.zeros(shape, np.float32)
            else:
                a = 0.02 * rng.standard_normal(shape, dtype=np.float32)
                if "norm" in name:
                    a += 1.0
            tensors[name] = torch.from_numpy(a).to(torch.bfloat16)
        write_safetensors(os.path.join(path, shard), tensors)
        total += os.path.getsize(os.path.join(path, shard))
    if n_shards > 1:
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"weight_map": weight_map}, f)
    else:
        os.replace(os.path.join(path, names[0]),
                   os.path.join(path, "model.safetensors"))
    pieces = ([("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
               ("▁", -5.0, 1)]
              + [(chr(c), -10.0, 1) for c in range(ord("a"), ord("z") + 1)]
              + [(str(d), -10.0, 1) for d in range(10)]
              + [(ch, -10.0, 1) for ch in ".,:()%"]
              + [(f"<0x{b:02X}>", -20.0, 6) for b in range(256)])
    write_sentencepiece_model(os.path.join(path, "tokenizer.model"), pieces)
    return total


def _load_tokenizer(path: str):
    spm = os.path.join(path, "tokenizer.model")
    if os.path.exists(spm):
        return SentencePieceTokenizer(spm)
    tj = os.path.join(path, "tokenizer.json")
    if not os.path.exists(tj):
        raise FileNotFoundError(
            f"no tokenizer.model or tokenizer.json under {path}")
    try:
        from tokenizers import Tokenizer
    except ImportError as exc:
        raise ImportError(
            f"{path} has only tokenizer.json, which needs the 'tokenizers' "
            f"package (not installed); add a tokenizer.model to read it "
            f"without it") from exc
    return _FastWrapper(Tokenizer.from_file(tj))


class _FastWrapper:
    """A ``tokenizers.Tokenizer`` behind the encode/decode contract."""

    def __init__(self, fast):
        self._fast = fast

    def encode(self, text: str) -> List[int]:
        return self._fast.encode(text, add_special_tokens=False).ids

    def decode(self, ids) -> str:
        return self._fast.decode([int(i) for i in ids],
                                 skip_special_tokens=True)
