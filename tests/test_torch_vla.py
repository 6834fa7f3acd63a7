"""The port's VLA host modules and TinyVLA against the JAX package's:
confidence, processor, hybrid selection (both degradations included),
the TinyVLA decoder (seeded weights and artifacts/vla/pretrained_base.npz
crossed through ``vla/convert.py``), its greedy decode and its scorer.

Tolerances: host-side scores and confidences equal to 1e-12 (the same
float64 numpy arithmetic); TinyVLA logits 1e-4 relative with 1e-5
absolute (f32, another order of sums); greedy tokens and parsed scores
equal.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leafgrasp_tpu.vla import confidence as jconf
from leafgrasp_tpu.vla import hybrid as jhyb
from leafgrasp_tpu.vla import lm as jlm
from leafgrasp_tpu.vla import processor as jproc
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
import leafgrasp_tpu_torch.vla as tvla
from leafgrasp_tpu_torch.vla import confidence as tconf
from leafgrasp_tpu_torch.vla import convert
from leafgrasp_tpu_torch.vla import hybrid as thyb
from leafgrasp_tpu_torch.vla import lm as tlm
from leafgrasp_tpu_torch.vla import lora as tlora
from leafgrasp_tpu_torch.vla import processor as tproc

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _candidates(seed, n=5):
    rng = np.random.default_rng(seed)
    return [dict(leaf_id=i + 1, x=int(rng.integers(5, 60)),
                 y=int(rng.integers(5, 60)),
                 clutter_score=float(rng.uniform(0.2, 1)),
                 distance_score=float(rng.uniform(0.2, 1)),
                 visibility_score=float(rng.uniform(0.2, 1)),
                 geometric_score=float(rng.uniform(0.2, 1)))
            for i in range(n)]


# ---- confidence ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_confidence_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    v, g = rng.random(5).tolist(), rng.random(5).tolist()
    for name in ("score_consistency", "calculate_confidence"):
        assert abs(getattr(tconf, name)(v, g)
                   - getattr(jconf, name)(v, g)) <= 1e-12
    for name in ("score_variance", "score_magnitude"):
        assert abs(getattr(tconf, name)(v) - getattr(jconf, name)(v)) \
            <= 1e-12
    # constant and single scores: the correlation is undefined
    assert tconf.score_consistency([0.5] * 4, g[:4]) == \
        jconf.score_consistency([0.5] * 4, g[:4]) == 0.5
    assert tconf.score_consistency(v[:1], g[:1]) == 0.5
    assert tconf.calculate_confidence([], g) == 0.0


def test_confidence_manager_history_matches_jax():
    rng = np.random.default_rng(4)
    a, b = tconf.ConfidenceManager(max_history=4), \
        jconf.ConfidenceManager(max_history=4)
    assert a.get_running_confidence() == 0.0 and not a.is_stable()
    for _ in range(7):
        v, g = rng.random(5), rng.random(5)
        assert a.calculate_confidence(v, g) == b.calculate_confidence(v, g)
    assert a.confidence_history == b.confidence_history
    assert len(a.confidence_history) == 4
    assert a.get_running_confidence() == b.get_running_confidence()
    assert a.is_stable(0.5) == b.is_stable(0.5)


# ---- processor -------------------------------------------------------------------

def test_build_prompt_matches_jax():
    for cand in _candidates(5) + [{}]:
        assert tproc.build_prompt(cand, "Pick a leaf") == \
            jproc.build_prompt(cand, "Pick a leaf")


@pytest.mark.parametrize("text", ["0.73", " 0.2\n", "1.7", "-3", "abc", "",
                                  "0.5 maybe", "1e-1"])
def test_parse_score_matches_jax(text):
    assert tproc.parse_score(text) == jproc.parse_score(text)
    assert tproc.parse_score(text, default=0.1) == \
        jproc.parse_score(text, default=0.1)


@pytest.mark.parametrize("scores", [[], [0.4], [0.3, 0.3, 0.3],
                                    [0.1, 0.9, 0.5], [0.0, 1.0]])
def test_normalize_and_confidence_match_jax(scores):
    assert tproc.normalize_scores(scores) == jproc.normalize_scores(scores)
    assert tproc.get_confidence(scores) == jproc.get_confidence(scores)
    assert tproc.VLAProcessor().get_confidence(scores) == \
        jproc.get_confidence(scores)


def test_stub_and_heuristic_scorers_match_jax():
    cands = _candidates(6)
    assert tproc.StubScorer().score(None, cands, "x") == [0.5] * 5
    assert tproc.HeuristicScorer().score(None, cands, "x") == \
        jproc.HeuristicScorer().score(None, cands, "x")
    for backend_t, backend_j in ((None, None),
                                 (tproc.HeuristicScorer(),
                                  jproc.HeuristicScorer())):
        assert tproc.VLAProcessor(backend_t).evaluate_candidates(
            None, cands) == jproc.VLAProcessor(backend_j) \
            .evaluate_candidates(None, cands)
    assert tproc.VLAProcessor().evaluate_candidates(None, []) == []


class _Boom:
    def score(self, *a, **k):
        raise RuntimeError("backend failure injection")


class _BoomProcessor:
    def evaluate_candidates(self, *a, **k):
        raise RuntimeError("processor failure injection")


def test_processor_degrades_to_uniform_scores():
    cands = _candidates(7)
    assert tproc.VLAProcessor(_Boom()).evaluate_candidates(None, cands) \
        == jproc.VLAProcessor(_Boom()).evaluate_candidates(None, cands) \
        == [0.5] * 5


# ---- hybrid ----------------------------------------------------------------------

@pytest.mark.parametrize("conf", [0.0, 0.2, 0.21, 0.5, 0.51, 0.8, 0.81, 1.0])
def test_ladder_and_strategy_match_jax(conf):
    assert thyb.confidence_weights(conf) == jhyb.confidence_weights(conf)
    assert thyb.selection_strategy(conf) == jhyb.selection_strategy(conf)
    assert thyb.HybridSelector().get_selection_strategy(conf) == \
        jhyb.selection_strategy(conf)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hybrid_selector_matches_jax(seed):
    rng = np.random.default_rng(seed)
    cands = _candidates(seed)
    geo, vla = rng.random(5), rng.random(5)
    for conf in (0.1, 0.4, 0.7, 0.9):
        assert thyb.HybridSelector().select_best_candidate(
            cands, geo, vla, conf) == jhyb.HybridSelector() \
            .select_best_candidate(cands, geo, vla, conf)
    assert thyb.HybridSelector().select_best_candidate([], [], [], 0.5) \
        is None
    custom = ((0.9, 0.5),)
    assert thyb.HybridSelector(custom).select_best_candidate(
        cands, geo, vla, 0.95) == jhyb.HybridSelector(custom) \
        .select_best_candidate(cands, geo, vla, 0.95)


@pytest.mark.parametrize("backend", ["none", "stub", "heuristic",
                                     "backend_raises", "processor_raises"])
def test_hybrid_grasp_selector_matches_jax(backend):
    """Both degradations: a backend that raises gives uniform scores, a
    processor that raises gives the geometric choice."""
    cands = _candidates(8)

    def make(mod_h, mod_p):
        if backend == "none":
            return mod_h.HybridGraspSelector()
        if backend == "processor_raises":
            return mod_h.HybridGraspSelector(_BoomProcessor())
        scorer = {"stub": mod_p.StubScorer, "heuristic": mod_p.HeuristicScorer,
                  "backend_raises": _Boom}[backend]()
        return mod_h.HybridGraspSelector(mod_p.VLAProcessor(scorer))

    a, b = make(thyb, tproc), make(jhyb, jproc)
    image = np.zeros((8, 8, 3), np.float32)
    for _ in range(2):
        assert a.select_grasp_point(image, cands) == \
            b.select_grasp_point(image, cands)
    assert a.select_grasp_point(image, []) is None
    assert a.confidence_manager.confidence_history == \
        b.confidence_manager.confidence_history
    if backend != "heuristic":
        best = a.select_grasp_point(image, cands)
        assert best["leaf_id"] == max(
            cands, key=lambda c: c["geometric_score"])["leaf_id"]


# ---- TinyVLA ----------------------------------------------------------------------

def _tiny_pair(seed=0, **kw):
    jcfg = jlm.VLAModelConfig(**kw)
    jmodel, variables = jlm.init_vla(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 50)
    variables = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
        .astype(np.float32), variables)
    tmodel = tlm.TinyVLA(tlm.VLAModelConfig(**kw), device="cpu").eval()
    tmodel.load_state_dict(convert.flax_to_torch_tiny_vla(variables))
    return jmodel, variables, tmodel


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_byte_tokenizer_matches_jax():
    a, b = tlm.ByteTokenizer(), jlm.ByteTokenizer()
    for text in ("0.25", "Task: héllo ✓", ""):
        np.testing.assert_array_equal(a.encode(text), b.encode(text))
        np.testing.assert_array_equal(a.encode(text, add_bos=False),
                                      b.encode(text, add_bos=False))
    ids = [256, 48, 46, 53, 257, 300, 258]
    assert a.decode(ids) == b.decode(ids) == "0.5"
    assert (a.bos, a.eos, a.img, a.vocab_size) == (256, 257, 258, 260)


def test_tiny_rope_matches_jax():
    """The split-half-pairs form. It is written differently from the
    LLaVA stack's ``_rope_hf`` (rotate_half) but pairs the same elements
    at the same frequencies: the two agree to rounding."""
    from leafgrasp_tpu_torch.vla.llava_torch import _rope_hf
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 6)).astype(np.int32)
    got = tlm._rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    _close(got, jlm._rope(jnp.asarray(x), jnp.asarray(pos), 1e4), rtol=1e-5)
    _close(_rope_hf(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           got.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("patch", [64, 30])
def test_vision_encoder_matches_jax(patch):
    """Stride-2 SAME convolutions pad on one side for an even size and
    on both for an odd one."""
    jmodel, variables, tmodel = _tiny_pair(vision_patch=patch,
                                           vision_tokens=4)
    image = np.random.default_rng(10).random((2, patch, patch, 3)) \
        .astype(np.float32)
    want = jlm.VisionEncoder(jmodel.cfg).apply(
        {"params": variables["params"]["vision"]}, jnp.asarray(image))
    _close(tmodel.vision(torch.from_numpy(image)), want)


@pytest.mark.parametrize("lora_rank", [0, 4])
@pytest.mark.parametrize("with_image", [True, False])
def test_tiny_vla_logits_match_jax(lora_rank, with_image):
    jmodel, variables, tmodel = _tiny_pair(seed=1, lora_rank=lora_rank,
                                           lora_alpha=16.0)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 260, (2, 9)).astype(np.int32)
    image = rng.random((2, 64, 64, 3)).astype(np.float32)
    jimg = jnp.asarray(image) if with_image else None
    timg = torch.from_numpy(image) if with_image else None
    want, _ = jmodel.apply(variables, jnp.asarray(toks), image=jimg)
    with torch.no_grad():
        got, caches = tmodel(torch.from_numpy(toks).long(), image=timg)
    assert caches is None and got.shape == (2, 9 + 4 * with_image, 260)
    _close(got, want)
    if lora_rank:
        assert "layers.0.attn.q_proj.lora_a" in tmodel.state_dict()
        assert float(tmodel.layers[0].mlp.up_proj.lora_b.detach().abs()
                     .max()) > 0


def _pretrained_pair():
    """artifacts/vla/pretrained_base.npz in both packages."""
    import flax.traverse_util as tu
    npz = np.load(ROOT / "artifacts" / "vla" / "pretrained_base.npz")
    jmodel = jlm.TinyVLA(jlm.VLAModelConfig())
    jvars = {"params": tu.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in npz.items()})}
    tmodel = tlm.TinyVLA(tlm.VLAModelConfig(), device="cpu").eval()
    tmodel.load_state_dict(convert.flax_to_torch_tiny_vla(npz))
    return jmodel, jvars, tmodel


def test_pretrained_base_loads_and_matches_jax():
    jmodel, jvars, tmodel = _pretrained_pair()
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 256, (1, 20)).astype(np.int32)
    image = rng.random((1, 64, 64, 3)).astype(np.float32)
    want, _ = jmodel.apply(jvars, jnp.asarray(toks), image=jnp.asarray(image))
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(toks).long(),
                        image=torch.from_numpy(image))
    _close(got, want)


@pytest.mark.parametrize("which", ["seeded", "pretrained"])
def test_tiny_greedy_generate_tokens_equal_jax(which):
    jmodel, jvars, tmodel = _pretrained_pair() if which == "pretrained" \
        else _tiny_pair(seed=2)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, 256, (2, 15)).astype(np.int32)
    image = rng.random((2, 64, 64, 3)).astype(np.float32)
    for jimg, timg in ((jnp.asarray(image), torch.from_numpy(image)),
                       (None, None)):
        want = jlm.greedy_generate(jmodel, jvars, jnp.asarray(toks),
                                   image=jimg, max_new_tokens=6)
        got = tlm.greedy_generate(tmodel, torch.from_numpy(toks).long(),
                                  image=timg, max_new_tokens=6)
        assert got.shape == (2, 6) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tiny_vla_scorer_scores_equal_jax():
    from leafgrasp_tpu_torch.utils import device as tdevice
    jmodel, jvars, tmodel = _pretrained_pair()
    cands = _candidates(14, 3)
    image = np.random.default_rng(14).random((40, 52, 3)).astype(np.float32)
    want = jproc.TinyVLAScorer(model=jmodel, variables=jvars) \
        .score(image, cands, "Select the best leaf")
    tdevice.reset_host_reads()
    got = tproc.TinyVLAScorer(model=tmodel).score(
        image, cands, "Select the best leaf")
    assert got == want
    assert tdevice.host_reads() == len(cands)     # one read a candidate
    grey = (image[..., 0] * 255).astype(np.uint8)
    assert tproc.TinyVLAScorer(model=tmodel).score(grey, cands[:1], "x") == \
        jproc.TinyVLAScorer(model=jmodel, variables=jvars) \
        .score(grey, cands[:1], "x")
    assert tproc.TinyVLAScorer(model=tmodel).score(None, cands[:1], "x") == \
        jproc.TinyVLAScorer(model=jmodel, variables=jvars) \
        .score(None, cands[:1], "x")


def test_init_vla_is_seeded_and_needs_a_device():
    cfg = tlm.VLAModelConfig(dim=32, n_heads=2, n_kv_heads=1, mlp_hidden=48,
                             lora_rank=2)
    a, b, c = (tlm.init_vla(s, cfg, device="cpu") for s in (0, 0, 1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["lm_head.weight"], sc["lm_head.weight"])
    assert not sa["layers.0.attn.q_proj.lora_b"].any()
    assert not a.training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tlm.init_vla(0, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            tproc.TinyVLAScorer()
        with pytest.raises(RuntimeError, match="CUDA"):
            tlm.TinyVLA(cfg)                      # the class itself too


def test_lora_dense_forward_and_merge_match_jax():
    from leafgrasp_tpu.vla.lora import LoRADense as JLoRADense
    rng = np.random.default_rng(15)
    x = rng.standard_normal((3, 10)).astype(np.float32)
    params = {"base": {"kernel": rng.standard_normal((10, 6))
                       .astype(np.float32),
                       "bias": rng.standard_normal(6).astype(np.float32)},
              "lora_a": rng.standard_normal((10, 2)).astype(np.float32),
              "lora_b": rng.standard_normal((2, 6)).astype(np.float32)}
    want = JLoRADense(6, rank=2, alpha=8.0, use_bias=True).apply(
        {"params": params}, jnp.asarray(x))
    layer = tlora.LoRADense(10, 6, rank=2, alpha=8.0, use_bias=True).eval()
    state = {"base.weight": torch.from_numpy(params["base"]["kernel"].T.copy()),
             "base.bias": torch.from_numpy(params["base"]["bias"])}
    adapter = {"lora_a": torch.from_numpy(params["lora_a"]),
               "lora_b": torch.from_numpy(params["lora_b"])}
    layer.load_state_dict(tlora.merge_lora_params(state, adapter))
    with torch.no_grad():
        _close(layer(torch.from_numpy(x)), want)
        # no compute type: a bf16 input is promoted to the f32 parameters
        assert layer(torch.from_numpy(x).bfloat16()).dtype == torch.float32
    # dropout in training mode draws from the trainer's generator only
    # (tests/test_torch_vla_training.py holds the masks)
    train = tlora.LoRADense(10, 6, rank=2, dropout=0.1).train()
    with pytest.raises(RuntimeError, match="generator"):
        train(torch.from_numpy(x))


def test_convert_tree_helpers():
    flat = {"a/b/kernel": np.ones((2, 3), np.float32),
            "a/c": np.zeros(2, np.float32)}
    tree = convert.unflatten_tree(flat)
    assert set(tree["a"]) == {"b", "c"} and tree["a"]["b"]["kernel"].shape \
        == (2, 3)
    with pytest.raises(KeyError):
        convert.flax_to_torch_tiny_vla({"params": {"mystery": {}}})
    with pytest.raises(KeyError):
        convert.flax_to_torch_llava({"params": {"mystery": {}}})


# ---- the package -------------------------------------------------------------------

def test_vla_package_exports_and_names_what_waits():
    import leafgrasp_tpu.vla as jvla
    renamed = {"LlavaJax": "LlavaTorch", "LlavaJaxConfig": "LlavaTorchConfig",
               "LlavaJaxScorer": "LlavaTorchScorer"}
    # every public name of the JAX package's vla is ported now
    for name in jvla.__all__:
        name = renamed.get(name, name)
        assert name in tvla.__all__ and hasattr(tvla, name), name
    with pytest.raises(AttributeError):
        tvla.no_such_name
    from leafgrasp_tpu_torch.vla import read_safetensors  # noqa: F401


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nothing under the port, its smoke script, its examples or its
    tools imports jax, flax, ml_dtypes or leafgrasp_tpu anywhere, or
    transformers or PIL when a module is imported (the legacy HF loader
    takes transformers, and the visualizer PIL, inside the function that
    needs it)."""
    files = list((ROOT / "leafgrasp_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"] \
        + list((ROOT / "examples").glob("*_torch.py")) \
        + list((ROOT / "tools").glob("*_torch.py"))
    assert ROOT / "tools" / "train_llava_lora_torch.py" in files
    assert len(files) > 50
    banned = re.compile(
        r"^\s*(?:import|from)\s+(jax|flax|ml_dtypes|optax|orbax|"
        r"leafgrasp_tpu)(?:\.|\s|$)|^(?:import|from)\s+(PIL|transformers)"
        r"\b", re.M)
    for path in files:
        hit = banned.search(path.read_text())
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_vla_demo_runs_on_the_cpu(capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "run_vla_demo_torch", ROOT / "examples" / "run_vla_demo_torch.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    picks = demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert set(picks) == {"stub (degraded)", "heuristic", "tiny-vla",
                          "failing backend"}
    assert picks["heuristic"]["strategy"] == "VLA_DOMINANT"
    assert picks["failing backend"]["x"] == picks["stub (degraded)"]["x"]
    assert "strategy=" in out
