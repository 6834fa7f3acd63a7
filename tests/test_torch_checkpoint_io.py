"""The port's checkpoint IO (``leafgrasp_tpu_torch/vla/checkpoint_io.py``)
against the JAX package's and against the libraries it replaces, on the
CPU at tiny widths.

Bit-equal where the JAX package is exact: safetensors bytes and tensors,
token ids and decoded text, parsed config fields, quantized codes and
scales, greedy tokens and parsed scores. Logits: 2e-4 relative and
absolute against transformers (the JAX test's tolerance) and 1e-4
relative with 1e-5 absolute against the JAX package (different orders
of f32 sums in the two frameworks' products).
"""

import dataclasses
import json
import os
import random
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from leafgrasp_tpu.vla import checkpoint_io as jio
from leafgrasp_tpu.vla import llava_runtime as jr
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch.vla import checkpoint_io as tio
from leafgrasp_tpu_torch.vla import convert
from leafgrasp_tpu_torch.vla import llava_runtime as tr
from leafgrasp_tpu_torch.vla import llava_torch as tl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
IDS = np.array([[1, 5, 100, 100, 100, 100, 7, 9]], np.int32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


# ------------------------------------------------------- safetensors --

def _tensors(rng):
    return {
        "a.weight": rng.normal(size=(3, 5)).astype(np.float32),
        "b.bias": rng.normal(size=(7,)).astype(np.float16),
        "c.int": rng.integers(0, 100, size=(2, 2)).astype(np.int64),
        "d.bf16": rng.normal(size=(4, 3)).astype(ml_dtypes.bfloat16),
        "e.bool": np.array([True, False]),
        "f.i8": rng.integers(-128, 128, size=(3, 3)).astype(np.int8),
        "g.empty": np.zeros((0, 4), np.float32),
    }


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_safetensors_bytes_and_tensors_match_jax_and_the_library(tmp_path):
    rng = np.random.default_rng(0)
    arrays = _tensors(rng)
    meta = {"format": "pt"}
    jpath, tpath = str(tmp_path / "j.safetensors"), str(tmp_path /
                                                          "t.safetensors")
    jio.write_safetensors(jpath, arrays, metadata=meta)
    tio.write_safetensors(tpath, {k: _to_torch(v) for k, v in
                                  arrays.items()}, metadata=meta)
    # byte for byte: the same header order, no padding, the same data
    assert open(jpath, "rb").read() == open(tpath, "rb").read()

    back = tio.read_safetensors(jpath)
    assert list(back) == list(arrays)
    for k, v in arrays.items():
        assert back[k].device.type == "cpu"
        got = _to_numpy(back[k])
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got.view(np.uint8), v.view(np.uint8))
    assert back["d.bf16"].dtype == torch.bfloat16

    # the reference safetensors library, both ways
    st = pytest.importorskip("safetensors.numpy")
    lib = st.load_file(tpath)
    for k in ("a.weight", "b.bias", "c.int", "e.bool", "f.i8"):
        np.testing.assert_array_equal(lib[k], arrays[k])
    lpath = str(tmp_path / "lib.safetensors")
    st.save_file({k: arrays[k] for k in ("a.weight", "c.int", "f.i8")},
                 lpath)
    ours = tio.read_safetensors(lpath)
    for k in ("a.weight", "c.int", "f.i8"):
        np.testing.assert_array_equal(ours[k].numpy(), arrays[k])
    # JAX's reader on the port's file
    jback = jio.read_safetensors(tpath)
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(jback[k]).view(np.uint8),
                                      v.view(np.uint8))


def test_read_safetensors_views_the_file(tmp_path):
    """The tensors are views of the mapped file (no second copy), and
    writable without touching the file (copy-on-write)."""
    p = str(tmp_path / "m.safetensors")
    tio.write_safetensors(p, {"w": torch.arange(6, dtype=torch.float32)})
    t = tio.read_safetensors(p)["w"]
    before = open(p, "rb").read()
    t += 1
    assert open(p, "rb").read() == before
    assert tio.read_safetensors(p)["w"].tolist() == [0, 1, 2, 3, 4, 5]


def test_shard_index_routes_every_tensor(tmp_path):
    rng = np.random.default_rng(1)
    arrays = {f"t{i}": rng.normal(size=(i + 1, 2)).astype(np.float32)
              for i in range(5)}
    weight_map = {}
    for s, keys in enumerate((["t0", "t3"], ["t1", "t2", "t4"])):
        name = f"model-{s + 1:05d}-of-00002.safetensors"
        tio.write_safetensors(str(tmp_path / name),
                              {k: torch.from_numpy(arrays[k]) for k in keys})
        weight_map.update({k: name for k in keys})
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": weight_map}, f)
    ours = tio._read_state_dict(str(tmp_path))
    theirs = jio._read_state_dict(str(tmp_path))
    assert set(ours) == set(theirs) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])
    with pytest.raises(FileNotFoundError):
        tio._read_state_dict(str(tmp_path / "nowhere"))


# ------------------------------------------------------ sentencepiece --

def _byte_pieces():
    return [(f"<0x{b:02X}>", -20.0, 6) for b in range(256)]


def _both(tmp_path, pieces, **kw):
    """Write the model with both writers (the bytes must agree) and read
    it with both readers."""
    jp, tp = str(tmp_path / "j.model"), str(tmp_path / "t.model")
    jio.write_sentencepiece_model(jp, pieces, **kw)
    tio.write_sentencepiece_model(tp, pieces, **kw)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    return jio.SentencePieceTokenizer(jp), tio.SentencePieceTokenizer(tp)


def _same_tokenizer(jt, tt):
    for field in ("pieces", "scores", "types", "model_type",
                  "byte_fallback", "add_dummy_prefix", "unk_id", "bos_id",
                  "eos_id", "pad_id", "vocab"):
        assert getattr(jt, field) == getattr(tt, field), field


def test_sentencepiece_bpe_merge_order_matches_jax(tmp_path):
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
              ("▁", -5.0, 1),
              ("h", -10.0, 1), ("e", -10.0, 1), ("l", -10.0, 1),
              ("o", -10.0, 1),
              ("he", -1.0, 1), ("ll", -2.0, 1), ("hell", -0.5, 1)]
    jt, tt = _both(tmp_path, pieces, model_type="bpe",
                   add_dummy_prefix=True, byte_fallback=False)
    _same_tokenizer(jt, tt)
    ids = tt.encode("hello")
    assert [tt.pieces[i] for i in ids] == ["▁", "hell", "o"]
    assert ids == jt.encode("hello") and tt.decode(ids) == "hello"
    assert tt.encode("hello", add_bos=True, add_eos=True) == \
        jt.encode("hello", add_bos=True, add_eos=True)
    assert tt.unk_id in tt.encode("hq") and tt.encode("hq") == \
        jt.encode("hq")


def test_sentencepiece_byte_fallback_matches_jax(tmp_path):
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
              ("▁", -5.0, 1), ("a", -10.0, 1)] + _byte_pieces()
    jt, tt = _both(tmp_path, pieces, model_type="bpe", byte_fallback=True)
    text = "a é 葉a"
    ids = tt.encode(text)
    assert tt.unk_id not in ids and ids == jt.encode(text)
    assert tt.decode(ids) == jt.decode(ids) == text


def test_sentencepiece_unigram_viterbi_matches_jax(tmp_path):
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
              ("▁", -1.0, 1),
              ("a", -3.0, 1), ("b", -3.0, 1), ("c", -3.0, 1),
              ("ab", -2.0, 1), ("abc", -1.0, 1)]
    jt, tt = _both(tmp_path, pieces, model_type="unigram",
                   add_dummy_prefix=True, byte_fallback=False)
    for text in ("abc", "abca", "zz abq"):
        assert tt.encode(text) == jt.encode(text), text
    assert [tt.pieces[i] for i in tt.encode("abca")] == ["▁", "abc", "a"]


def _fuzz_pieces(rng, alpha, byte_fallback, n_pieces=40):
    """Random piece inventory with distinct scores (the JAX test's)."""
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
              ("▁", -4.0, 1)]
    if byte_fallback:
        pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    pieces += [(c, -10.0 - i * 0.001, 1) for i, c in enumerate(alpha)]
    seen = {p[0] for p in pieces}
    used_scores = set()
    target = len(pieces) + n_pieces
    while len(pieces) < target:
        w = "".join(rng.choice(alpha) for _ in range(rng.randint(2, 5)))
        if rng.random() < 0.4:
            w = "▁" + w[:-1]
        s = round(rng.uniform(-9.5, -0.5), 4)
        if w in seen or s in used_scores:
            continue
        seen.add(w)
        used_scores.add(s)
        pieces.append((w, s, 1))
    return pieces


@pytest.mark.parametrize("model_type,byte_fallback",
                         [("bpe", False), ("bpe", True),
                          ("unigram", False), ("unigram", True)])
def test_sentencepiece_fuzz_matches_jax(tmp_path, model_type, byte_fallback):
    """The fuzz of the JAX package's cross-implementation test, the port
    against the JAX reader: the same ids and the same decoded text."""
    alpha = "abc" if byte_fallback else "abcde"
    extra = "  zé€" if byte_fallback else "  "
    rng = random.Random(0)
    for seed in range(3):
        rng.seed(seed)
        pieces = _fuzz_pieces(rng, alpha, byte_fallback)
        jt, tt = _both(tmp_path, pieces, model_type=model_type,
                       byte_fallback=byte_fallback)
        _same_tokenizer(jt, tt)
        for _ in range(50):
            n = rng.randint(0, 12)
            s = "".join(rng.choice(alpha + extra) for _ in range(n)).strip()
            ids = tt.encode(s)
            assert ids == jt.encode(s), (model_type, s)
            assert tt.decode(ids) == jt.decode(ids) == s


def test_sentencepiece_empty_input_and_negative_ids(tmp_path):
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
              ("▁", -5.0, 1), ("a", -1.0, 1)]
    jt, tt = _both(tmp_path, pieces, model_type="bpe",
                   byte_fallback=False, pad_id=-1)
    assert tt.encode("") == jt.encode("") == []
    assert tt.encode("", add_bos=True) == [tt.bos_id]
    assert tt.pad_id == jt.pad_id == -1
    assert bytes([0xFF] * 8 + [0x01]) in open(tmp_path / "t.model",
                                              "rb").read()
    for v in (-1, -7, 0, 3, 300):
        assert tio._emit_i32(v) == jio._emit_i32(v)
    # ids out of range decode to nothing, as in JAX
    assert tt.decode([-1, 4, 999]) == jt.decode([-1, 4, 999]) == "a"


def test_dict_config_attribute_view():
    c = tio.DictConfig({"a": 1, "b": {"c": 2}})
    assert c.a == 1 and c.b.c == 2
    assert getattr(c, "missing", "dflt") == "dflt"
    with pytest.raises(AttributeError):
        c.missing


# -------------------------------------------- full 7B v1.6 metadata --

FULL_7B_V16_CONFIG = {
    "architectures": ["LlavaNextForConditionalGeneration"],
    "model_type": "llava_next",
    "ignore_index": -100,
    "image_token_index": 32000,
    "projector_hidden_act": "gelu",
    "vision_feature_layer": -2,
    "vision_feature_select_strategy": "default",
    "image_grid_pinpoints": [[336, 672], [672, 336], [672, 672],
                             [1008, 336], [336, 1008]],
    "text_config": {
        "model_type": "mistral", "hidden_size": 4096,
        "intermediate_size": 14336, "num_attention_heads": 32,
        "num_hidden_layers": 32, "num_key_value_heads": 8,
        "rms_norm_eps": 1e-05, "rope_theta": 1000000.0,
        "sliding_window": None, "vocab_size": 32064,
        "max_position_embeddings": 32768, "torch_dtype": "bfloat16",
    },
    "vision_config": {
        "model_type": "clip_vision_model", "hidden_size": 1024,
        "intermediate_size": 4096, "num_attention_heads": 16,
        "num_hidden_layers": 24, "image_size": 336, "patch_size": 14,
        "projection_dim": 768, "vocab_size": 32000,
    },
    "torch_dtype": "float16",
    "vocab_size": 32064,
}


@pytest.mark.parametrize("raw", ["full_7b", "sparse"])
def test_parse_llava_config_matches_jax(raw):
    """Every field of the parsed config equals the JAX package's: the
    published 7B v1.6 config.json, and one that leaves the defaults to
    the parser (no text heads for K/V, no vision config)."""
    if raw == "full_7b":
        d = FULL_7B_V16_CONFIG
    else:
        d = {"image_token_index": 7, "vision_feature_layer": -1,
             "text_config": {"hidden_size": 64, "intermediate_size": 96,
                             "num_hidden_layers": 2,
                             "num_attention_heads": 4, "vocab_size": 128}}
    j, t = jio.parse_llava_config(d), tio.parse_llava_config(d)
    tf = {f.name for f in dataclasses.fields(t)}
    for f in dataclasses.fields(j):
        if f.name == "quant_packed":      # JAX's int4 storage choice; the
            assert j.quant_packed is False    # port stores int4 packed
            continue
        assert f.name in tf, f.name
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    if raw == "full_7b":
        assert (t.hidden, t.intermediate, t.layers) == (4096, 14336, 32)
        assert (t.heads, t.kv_heads, t.head_dim, t.num_patches) == \
            (32, 8, 128, 576)


# ---------------------------------------------------- the load path --

def _prompt_vocab_model(path, writer=tio.write_sentencepiece_model):
    """A BPE tokenizer.model whose ids stay inside the tiny vocab (128)."""
    pieces = ([("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
               ("▁", -5.0, 1)]
              + [(chr(c), -10.0, 1) for c in range(ord("a"), ord("z") + 1)]
              + [(str(d), -10.0, 1) for d in range(10)]
              + [(ch, -10.0, 1) for ch in ".,:()%"])
    writer(path, pieces, model_type="bpe", byte_fallback=False)


def _write_sharded(d, sd, n_shards=2):
    names = sorted(sd)
    per = -(-len(names) // n_shards)
    weight_map = {}
    for s in range(n_shards):
        shard = f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"
        keys = names[s * per:(s + 1) * per]
        tio.write_safetensors(str(d / shard), {k: sd[k] for k in keys})
        weight_map.update({k: shard for k in keys})
    with open(d / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": weight_map}, f)


@pytest.fixture(scope="module")
def tiny_ckpt_dir(tmp_path_factory):
    """A transformers LLaVA at tiny widths written as a sharded HF
    checkpoint directory by the port's own writers."""
    from transformers import (CLIPVisionConfig, LlavaConfig,
                              LlavaForConditionalGeneration, MistralConfig)
    vis = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=3, num_attention_heads=2,
                           image_size=28, patch_size=14)
    txt = MistralConfig(hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, vocab_size=128,
                        max_position_embeddings=128, attention_dropout=0.0)
    hf_cfg = LlavaConfig(vision_config=vis, text_config=txt,
                         image_token_index=100, vision_feature_layer=-2,
                         vision_feature_select_strategy="default")
    torch.manual_seed(7)
    hf = LlavaForConditionalGeneration(hf_cfg).eval()
    d = tmp_path_factory.mktemp("ckpt")
    with open(d / "config.json", "w") as f:
        json.dump(hf_cfg.to_dict(), f)
    _write_sharded(d, {k: v.detach().clone()
                       for k, v in hf.state_dict().items()})
    _prompt_vocab_model(str(d / "tokenizer.model"))
    return str(d), hf


def _jax_logits(model, variables, px):
    out, _ = model.apply(variables, IDS, pixel_values=px)
    return np.asarray(out, np.float32)


def _torch_logits(model, px):
    with torch.no_grad():
        out, _ = model(torch.from_numpy(IDS).long(),
                       pixel_values=torch.from_numpy(px))
    return _np(out)


def test_load_checkpoint_matches_transformers_and_jax(tiny_ckpt_dir,
                                                      monkeypatch):
    path, hf = tiny_ckpt_dir
    px = np.random.default_rng(3).normal(size=(1, 28, 28, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(IDS).long(),
                 pixel_values=torch.from_numpy(px.transpose(0, 3, 1, 2))
                 ).logits.numpy()
    jmodel, jvars, _ = jio.load_llava_checkpoint(path)
    want = _jax_logits(jmodel, jvars, px)

    # the load path needs no transformers
    monkeypatch.setitem(sys.modules, "transformers", None)
    model, state, tok = tio.load_llava_checkpoint(path, device="cpu")
    got = _torch_logits(model, px)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert model.device.type == "cpu" and model.cfg.lora_rank == 0
    # the returned state is the model's own tensors
    assert state["embed_tokens.weight"].data_ptr() == \
        model.embed_tokens.weight.data_ptr()
    # the weights equal the JAX loader's, carried across
    carried = convert.flax_to_torch_llava(jvars)
    assert set(carried) == set(state)
    for k, v in carried.items():
        assert torch.equal(state[k], v), k
    assert isinstance(tok, tio.SentencePieceTokenizer)
    assert tok.decode(tok.encode("score: 85")) == "score: 85"


def test_load_checkpoint_bf16_cast_matches_jax(tiny_ckpt_dir):
    path, _ = tiny_ckpt_dir
    _, jvars, _ = jio.load_llava_checkpoint(path, dtype="bfloat16")
    model, state, _ = tio.load_llava_checkpoint(path, dtype="bfloat16",
                                                device="cpu")
    assert model.cfg.dtype == "float32"          # the compute type, as JAX
    leaf = jvars["params"]["embed_tokens"]["embedding"]
    assert leaf.dtype == jnp.bfloat16
    assert state["embed_tokens.weight"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["embed_tokens.weight"].view(torch.int16).numpy(),
        np.asarray(leaf).view(np.int16))
    assert all(v.dtype == torch.bfloat16 for v in state.values())
    px = np.random.default_rng(4).normal(size=(1, 28, 28, 3)) \
        .astype(np.float32)
    jmodel, _, _ = jio.load_llava_checkpoint(path)
    np.testing.assert_allclose(_torch_logits(model, px),
                               _jax_logits(jmodel, jvars, px),
                               rtol=RTOL, atol=ATOL)


class _Tok:
    """Fixed-length stub tokenizer with an injective decode, so that the
    parsed scores of a random model differ between candidates."""

    def encode(self, text):
        data = np.frombuffer(text.encode(), np.uint8).astype(np.int64)
        fold = np.zeros(-(-len(data) // 24) * 24, np.int64)
        fold[:len(data)] = data
        return [1] + (fold.reshape(-1, 24).sum(axis=0) % 88 + 3).tolist()

    def decode(self, ids):
        key = 0
        for i in ids:
            key = (key * 1000003 + int(i) + 1) % (10 ** 9)
        return f"0.{key:09d}"


def _cands():
    return [{"x": 3, "y": 4, "leaf_id": 1, "geometric_score": 0.8},
            {"x": 9, "y": 2, "leaf_id": 2, "geometric_score": 0.6},
            {"x": 20, "y": 11, "leaf_id": 3, "geometric_score": 0.5}]


def test_scorer_from_disk_checkpoint_matches_jax(tiny_ckpt_dir,
                                                 monkeypatch):
    path, _ = tiny_ckpt_dir
    img = (np.random.default_rng(5).random((28, 28, 3)) * 255) \
        .astype(np.uint8)
    jmodel, jvars, jtok = jio.load_llava_checkpoint(path)
    monkeypatch.setitem(sys.modules, "transformers", None)
    model, _, tok = tio.load_llava_checkpoint(path, device="cpu")
    for t_tok, j_tok in ((tok, jtok), (_Tok(), _Tok())):
        want = jr.LlavaJaxScorer(jmodel, jvars, j_tok, max_new_tokens=4) \
            .score(img, _cands(), "pick the best leaf")
        scorer = tr.LlavaTorchScorer(model, t_tok, max_new_tokens=4)
        got = scorer.score(img, _cands(), "pick the best leaf")
        assert got == want and all(np.isfinite(got))
    assert len(set(got)) > 1


@pytest.fixture(scope="module")
def tiny_next_ckpt_dir(tmp_path_factory):
    """A transformers LLaVA-NeXT (v1.6: anyres pinpoints, image_newline)
    at tiny widths, written as one safetensors file."""
    from transformers import (CLIPVisionConfig, LlavaNextConfig,
                              LlavaNextForConditionalGeneration,
                              MistralConfig)
    vis = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=28, patch_size=14)
    txt = MistralConfig(hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, vocab_size=128,
                        max_position_embeddings=512)
    hf_cfg = LlavaNextConfig(
        vision_config=vis, text_config=txt, image_token_index=100,
        vision_feature_layer=-2, vision_feature_select_strategy="default",
        image_grid_pinpoints=[[28, 56], [56, 28], [56, 56]])
    torch.manual_seed(11)
    hf = LlavaNextForConditionalGeneration(hf_cfg).eval()
    d = tmp_path_factory.mktemp("ckpt_next")
    with open(d / "config.json", "w") as f:
        json.dump(hf_cfg.to_dict(), f)
    tio.write_safetensors(str(d / "model.safetensors"),
                          {k: v.detach().clone()
                           for k, v in hf.state_dict().items()})
    _prompt_vocab_model(str(d / "tokenizer.model"))
    return str(d)


def test_anyres_scorer_from_disk_checkpoint_matches_jax(tiny_next_ckpt_dir,
                                                        monkeypatch):
    jmodel, jvars, _ = jio.load_llava_checkpoint(tiny_next_ckpt_dir)
    monkeypatch.setitem(sys.modules, "transformers", None)
    model, state, _ = tio.load_llava_checkpoint(tiny_next_ckpt_dir,
                                                device="cpu")
    assert model.cfg.image_grid_pinpoints == ((28, 56), (56, 28), (56, 56))
    assert "image_newline" in state
    img = (np.random.default_rng(5).random((40, 50, 3)) * 255) \
        .astype(np.uint8)
    want = jr.LlavaJaxScorer(jmodel, jvars, _Tok(), max_new_tokens=4,
                             anyres=True).score(img, _cands(), "pick")
    got = tr.LlavaTorchScorer(model, _Tok(), max_new_tokens=4,
                              anyres=True).score(img, _cands(), "pick")
    assert got == want and len(set(got)) > 1


@pytest.mark.parametrize("n_shards,pinpoints", [(3, ((28, 56), (56, 28))),
                                                (1, None)])
def test_synthetic_checkpoint_loads_what_was_written(tmp_path, n_shards,
                                                     pinpoints):
    """The port's synthetic checkpoint writer (the smoke run's full-width
    checkpoint, here at tiny widths): the bf16 load holds exactly the
    bytes written, and JAX's loader reads the same directory to the same
    logits."""
    cfg = tl.LlavaTorchConfig(
        vis_hidden=32, vis_intermediate=64, vis_layers=2, vis_heads=2,
        image_size=28, patch_size=14, vocab_size=128, hidden=32,
        intermediate=64, layers=2, heads=4, kv_heads=2,
        image_token_index=100, image_grid_pinpoints=pinpoints)
    d = str(tmp_path / "synth")
    n_bytes = tio.write_synthetic_llava_checkpoint(d, cfg, seed=2,
                                                   n_shards=n_shards)
    written = tio._read_state_dict(d)
    assert n_bytes == sum(os.path.getsize(os.path.join(d, f))
                          for f in os.listdir(d)
                          if f.endswith(".safetensors"))
    assert n_bytes > sum(v.numel() * 2 for v in written.values())
    model, state, tok = tio.load_llava_checkpoint(d, dtype="bfloat16",
                                                  device="cpu")
    rename = tio._hf_name_map(model.cfg, written)
    assert set(rename.values()) == set(state)
    for src, dst in rename.items():
        assert torch.equal(state[dst].view(torch.int16),
                           written[src].view(torch.int16)), dst
    for f in ("hidden", "layers", "vocab_size", "image_grid_pinpoints",
              "kv_heads", "rms_eps", "rope_theta"):
        assert getattr(model.cfg, f) == getattr(cfg, f), f
    assert tok.decode(tok.encode("score: 85 é")) == "score: 85 é"
    jmodel, jvars, _ = jio.load_llava_checkpoint(d, dtype="bfloat16")
    px = np.random.default_rng(8).normal(size=(1, 28, 28, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(_torch_logits(model, px),
                               _jax_logits(jmodel, jvars, px),
                               rtol=RTOL, atol=ATOL)


# ------------------------------------------------ quantized loads --

@pytest.mark.parametrize("bits", [8, 4])
def test_load_checkpoint_quantized_matches_jax(tiny_ckpt_dir, bits):
    """quantize=True: the codes and scales equal the JAX loader's, carried
    across (int4 native packed by the converter), and equal the port's
    host quantizer on the float load; logits match JAX's quantized model
    and stay near the float load."""
    from leafgrasp_tpu_torch.vla.quant import quantize_llava_variables
    path, _ = tiny_ckpt_dir
    jmodel, jvars, _ = jio.load_llava_checkpoint(
        path, quantize=True, quant_bits=bits, quant_group=16)
    model, state, _ = tio.load_llava_checkpoint(
        path, quantize=True, quant_bits=bits, quant_group=16, device="cpu")
    assert model.cfg.quantized and model.cfg.quant_bits == bits
    q = state["layers.0.self_attn.q_proj.kernel_q"]
    assert q.dtype == torch.int8 and q.shape == ((32, 32) if bits == 8
                                                 else (16, 32))
    assert "lm_head.kernel_q" in state and "lm_head.weight" not in state
    carried = convert.flax_to_torch_llava(jvars)
    assert set(carried) == set(state)
    for k, v in carried.items():
        assert torch.equal(state[k], v), k
    _, fstate, _ = tio.load_llava_checkpoint(path, device="cpu")
    host = quantize_llava_variables(fstate, bits=bits, group=16)
    for k, v in host.items():
        assert torch.equal(state[k], v), k

    px = np.random.default_rng(3).normal(size=(1, 28, 28, 3)) \
        .astype(np.float32)
    got = _torch_logits(model, px)
    np.testing.assert_allclose(got, _jax_logits(jmodel, jvars, px),
                               rtol=RTOL, atol=ATOL)
    fmodel, _, _ = tio.load_llava_checkpoint(path, device="cpu")
    ref = _torch_logits(fmodel, px)
    assert np.abs(got - ref).max() < 0.1 * max(1.0, np.abs(ref).max())


def test_load_checkpoint_quantized_qlora(tiny_ckpt_dir):
    """quantize composes with lora_rank: the quantized base under
    ``base``, f32 adapters beside it; with lora_b zero the logits are the
    quantized model's, as in JAX."""
    from leafgrasp_tpu_torch.vla.lora import lora_mask
    path, _ = tiny_ckpt_dir
    model, state, _ = tio.load_llava_checkpoint(path, lora_rank=2,
                                                quantize=True, device="cpu")
    assert "layers.0.self_attn.q_proj.base.kernel_q" in state
    assert state["layers.0.self_attn.q_proj.lora_a"].dtype == torch.float32
    assert not state["layers.0.gate_proj.lora_b"].any()
    trainable = {k for k, v in lora_mask(state).items() if v}
    assert trainable and all(k.endswith(("lora_a", "lora_b"))
                             for k in trainable)
    jmodel, jvars, _ = jio.load_llava_checkpoint(path, lora_rank=2,
                                                 quantize=True)
    px = np.zeros((1, 28, 28, 3), np.float32)
    np.testing.assert_allclose(_torch_logits(model, px),
                               _jax_logits(jmodel, jvars, px),
                               rtol=RTOL, atol=ATOL)


# ------------------------------------------------ no silent fallback --

def test_load_checkpoint_without_cuda_raises(tiny_ckpt_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None loads onto it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.load_llava_checkpoint(tiny_ckpt_dir[0])       # device=None


def test_tokenizer_json_needs_tokenizers_and_names_it(tiny_ckpt_dir,
                                                      tmp_path,
                                                      monkeypatch):
    """A directory with only tokenizer.json reads it through the
    ``tokenizers`` package; without that package the loader raises an
    ImportError that names it."""
    from tokenizers import Tokenizer, models
    path, _ = tiny_ckpt_dir
    d = tmp_path / "fast"
    d.mkdir()
    for name in os.listdir(path):
        if name != "tokenizer.model":
            os.symlink(os.path.join(path, name), d / name)
    vocab = {"<unk>": 0, "a": 1, "b": 2}
    Tokenizer(models.WordLevel(vocab, unk_token="<unk>")).save(
        str(d / "tokenizer.json"))
    _, _, tok = tio.load_llava_checkpoint(str(d), device="cpu")
    assert tok.encode("a") == [1] and tok.decode([2]) == "b"
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="tokenizers"):
        tio.load_llava_checkpoint(str(d), device="cpu")


def test_load_llava_from_hf_matches_transformers(tiny_ckpt_dir, tmp_path):
    """The legacy loader, through transformers: a save_pretrained
    directory gives the logits of the model that was saved."""
    from tokenizers import Tokenizer, models
    from transformers import PreTrainedTokenizerFast
    _, hf = tiny_ckpt_dir
    hf.save_pretrained(str(tmp_path))
    PreTrainedTokenizerFast(tokenizer_object=Tokenizer(models.WordLevel(
        {"<unk>": 0, "a": 1}, unk_token="<unk>"))).save_pretrained(
        str(tmp_path))
    model, state, tok = tr.load_llava_from_hf(str(tmp_path), device="cpu")
    px = np.random.default_rng(6).normal(size=(1, 28, 28, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(IDS).long(),
                 pixel_values=torch.from_numpy(px.transpose(0, 3, 1, 2))
                 ).logits.numpy()
    np.testing.assert_allclose(_torch_logits(model, px), ref, rtol=2e-4,
                               atol=2e-4)
    assert tok.convert_tokens_to_ids("a") == 1
    model, state, _ = tr.load_llava_from_hf(str(tmp_path), lora_rank=2,
                                            dtype="bfloat16", device="cpu")
    assert state["layers.1.down_proj.base.weight"].dtype == torch.bfloat16
    assert state["layers.1.down_proj.lora_a"].dtype == torch.float32


# ---------------------------------------------------- the serve CLI --

def _cli(name):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import importlib
    return importlib.import_module(name)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_serve_cli_picks_the_jax_clis_leaf(tiny_next_ckpt_dir, capsys,
                                           quantize):
    """tools/serve_llava_torch.py: checkpoint dir -> the port's leaf stage
    -> batched anyres rerank -> fused choice, on the CPU: the same
    candidates and the same best leaf as tools/serve_llava.py."""
    argv = [tiny_next_ckpt_dir, "--dtype", "float32", "--anyres",
            "--frame-size", "96", "128", "--seed", "1",
            "--max-new-tokens", "4", "--quantize", quantize,
            "--quant-group", "16", "--json"]
    _cli("serve_llava").main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _cli("serve_llava_torch").main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["candidates"] and got["best"] is not None
    # the scorer's own record: the rerank ran to its end for every one
    n = len(got["candidates"])
    assert len(got["vla_scores"]) == n
    assert got["generated_tokens"] == [4] * n
    assert [c["leaf_id"] for c in got["candidates"]] == \
        [c["leaf_id"] for c in want["candidates"]]
    for a, b in zip(got["candidates"], want["candidates"]):
        for key in ("x", "y", "geometric_score"):
            assert a[key] == pytest.approx(b[key], rel=1e-5, abs=1e-5)
    assert got["best"]["leaf_id"] == want["best"]["leaf_id"]
    assert got["best"]["strategy"] == want["best"]["strategy"]
    assert got["best"]["vla_confidence"] == pytest.approx(
        want["best"]["vla_confidence"], abs=1e-6)


def test_serve_cli_rejects_the_auto_weight_layout(tiny_next_ckpt_dir):
    with pytest.raises(ValueError, match="auto"):
        _cli("serve_llava_torch").main(
            [tiny_next_ckpt_dir, "--device", "cpu", "--weight-layout",
             "auto", "--frame-size", "96", "128"])
