"""The port's measurement tools (bench_torch.py and tools/bench_*_torch.py)
against the JAX package's tools and records, on the CPU at small sizes.

* Every record carries the JAX tool's keys (from the committed records,
  BENCH_r05.json's ``parsed`` and artifacts/vla_service_bench*.json, or
  from the JAX tool's source) and one more, ``device``.
* bench_torch.py's measure function at 96 x 160 (the bench families'
  margins scaled, two frames a family): every frame's leaf, pixel and
  flags equal JAX ``make_frame_fn``'s with the same CNN weights
  (JAX's ``init_grasp_cnn(PRNGKey(0))``, converted).
* The threaded ingest tool at 96 x 160: every message it published equals
  the synchronous port service's and JAX ``GraspService``'s for the same
  mask and depth (pixel equal, floats within 1e-4, as
  tests/test_torch_service.py).
* The rerank stability tool's ``run_mode`` on the JAX tools' tiny LLaVA in
  f32 (JAX's weights converted, JAX's image): the same scores in both
  batchings for every candidate as JAX's ``run_mode``, and the same
  flip count.
* The VLA service tool's degradation checks and where it writes.
* A tool asked for the card without one raises; no tool imports JAX
  (the frame A/B and stage tools, tools/micro_bench_*_torch.py, too).
"""

import ast
import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax

import leafgrasp_tpu.config as jcfg
import leafgrasp_tpu_torch.config as tcfg
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

import bench_torch
from tools import (bench_rerank_stability_torch, bench_service_ingest_torch,
                   bench_vla_anyres_torch, bench_vla_quant_torch,
                   bench_vla_service_torch, bench_vla_torch,
                   micro_bench_batch_torch, micro_bench_edt_ab_torch,
                   micro_bench_frame_ab_torch, micro_bench_stages_torch)
from tools._torch_bench import TINY_LLAVA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
H, W = 96, 160
# the bench families (bench.py:37-41) with their margins scaled to 96 rows
FAMILIES = [(name, n, seed, margin * H // 1080)
            for name, n, seed, margin in bench_torch.FAMILIES]
CAMERA = (707.87 * W / 1440, 494.07 * H / 1080, 1750.68 * W / 1440)
MSG_TOL = 1e-4


def _small(mod, mode="union"):
    return mod.DEFAULT_CONFIG.replace(
        frame=mod.FrameConfig(height=H, width=W, max_leaves=16),
        leaf=mod.LeafSelectionConfig(min_leaf_area=500),
        grasp=mod.GraspScoringConfig(isolation_context=mode))


@functools.lru_cache(maxsize=None)
def _weights():
    from leafgrasp_tpu.models.grasp_cnn import init_grasp_cnn
    from leafgrasp_tpu_torch.models.convert import flax_to_torch_grasp_cnn
    from leafgrasp_tpu_torch.models.grasp_cnn import GraspPointCNN
    _, variables = init_grasp_cnn(jax.random.PRNGKey(0),
                                  jcfg.DEFAULT_CONFIG.model)
    model = GraspPointCNN(tcfg.ModelConfig()).eval()
    model.load_state_dict(flax_to_torch_grasp_cnn(
        jax.tree.map(np.asarray, variables)))
    return variables, model


def _record_keys(path, func):
    """The string keys of the largest dict literal or ``dict(...)`` call
    in ``func`` of the JAX tool at ``path``."""
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    best = []
    for node in ast.walk(fn):
        keys = []
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
        elif isinstance(node, ast.Call) and getattr(node.func, "id",
                                                    None) == "dict":
            keys = [k.arg for k in node.keywords if k.arg]
        best = max(best, keys, key=len)
    return set(best)


def _same_message(a, b):
    pa, pb = a.split(","), b.split(",")
    assert len(pa) == len(pb) == 8 and pa[:2] == pb[:2], (a, b)
    np.testing.assert_allclose([float(x) for x in pb[2:]],
                               [float(x) for x in pa[2:]], rtol=0,
                               atol=MSG_TOL)


# ---- bench_torch.py --------------------------------------------------------

@pytest.mark.parametrize("mode", ["reference_self", "union"])
def test_bench_measure_answers_equal_jax_make_frame_fn(mode):
    from leafgrasp_tpu.pipeline.frame import make_frame_fn
    variables, model = _weights()
    cfg = _small(tcfg, mode)
    frames = bench_torch.stage_frames(cfg, 2, CPU, FAMILIES)
    mixed, fam, answers = bench_torch.measure(cfg, frames, model, CPU,
                                              CAMERA)
    assert mixed > 0 and list(fam) == [f[0] for f in FAMILIES]
    jfn = make_frame_fn(_small(jcfg, mode), with_cnn=True)
    cam = [np.float32(v) for v in CAMERA]
    assert len(answers) == len(frames) == 6
    for (name, mask, depth), (fam_name, leaf, uv, found, deg) in zip(
            frames, answers):
        want = jfn(mask.numpy(), depth.numpy(), *cam, variables)
        assert fam_name == name
        assert leaf == int(want.leaf_id)
        assert uv == [int(v) for v in np.asarray(want.grasp_uv)]
        assert (found, deg) == (bool(want.found), bool(want.degenerate))
        assert found and not deg


def test_bench_main_prints_bench_py_keys_and_reads_the_port_record(
        monkeypatch, tmp_path, capsys):
    art = tmp_path / "vla_service_bench.json"
    art.write_text(json.dumps({"value": 1.5, "overlap_fps": 1.25,
                               "quantize": "int8", "dims": "7B",
                               "backend": "cuda", "recorded_unix": 1,
                               "git_rev": "0000000"}))
    monkeypatch.setattr(bench_torch, "bench_configs",
                        lambda: (_small(tcfg, "reference_self"),
                                 _small(tcfg, "union")))
    monkeypatch.setattr(bench_torch, "FAMILIES", FAMILIES)
    monkeypatch.setattr(bench_torch, "CAMERA", CAMERA)
    monkeypatch.setattr(bench_torch, "VLA_ARTIFACT", str(art))
    monkeypatch.setenv("LEAFGRASP_BENCH_PER_FAMILY", "1")
    answers = {}
    rec = bench_torch.main(["--device", "cpu"], answers=answers)
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == rec
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        want = json.load(f)["parsed"]
    assert set(rec) == set(want) | {"device"}
    assert set(rec["vla_service_provenance"]) == \
        set(want["vla_service_provenance"])
    assert rec["vla_service_provenance"]["tool"] == \
        "tools/bench_vla_service_torch.py"
    assert rec["vla_service_fps"] == 1.5 and rec["device"] == "cpu"
    assert "WARNING" in out.err and "0000000" in out.err
    assert rec["vs_baseline"] == round(rec["value"] / 50.0, 4)
    assert set(answers) == {"reference_self", "union"}
    assert [a[0] for a in answers["union"]] == [f[0] for f in FAMILIES]
    # without the port's record there is no VLA field (never the TPU's)
    monkeypatch.setattr(bench_torch, "VLA_ARTIFACT",
                        str(tmp_path / "absent.json"))
    assert bench_torch.vla_service_fields(bench_torch.VLA_ARTIFACT) == {}


# ---- tools/bench_service_ingest_torch.py -----------------------------------

def test_ingest_tool_publishes_the_sync_and_jax_messages(monkeypatch):
    from leafgrasp_tpu.pipeline.ingest import GraspService as JGraspService
    from leafgrasp_tpu_torch.io.framebus import native_available
    from leafgrasp_tpu_torch.io.scenes import default_projection
    from leafgrasp_tpu_torch.models import grasp_cnn
    from leafgrasp_tpu_torch.pipeline.ingest import GraspService
    variables, model = _weights()
    cfg = _small(tcfg, "reference_self")
    monkeypatch.setattr(bench_service_ingest_torch, "ingest_config",
                        lambda: cfg)
    monkeypatch.setattr(grasp_cnn, "init_grasp_cnn",
                        lambda seed, c: (model, model.state_dict()))
    published = []
    rec = bench_service_ingest_torch.main(
        ["--device", "cpu", "--frames", "6", "--depth", "1"],
        published=published)
    want_keys = _record_keys("tools/bench_service_ingest.py", "main")
    assert set(rec) == want_keys | {"device"}
    assert rec["bus"] == ("native" if native_available() else "numpy")
    assert rec["frames_processed"] == len(published) > 0
    assert rec["frames_pushed"] == 6
    assert rec["frames_dropped"] == 6 - rec["frames_processed"]

    raws = bench_service_ingest_torch.raw_frames(cfg, 6)
    sync = GraspService(cfg, cnn=model, min_interval_s=0.0, device="cpu")
    jsvc = JGraspService(_small(jcfg, "reference_self"),
                         cnn_variables=variables, min_interval_s=0.0)
    for svc in (sync, jsvc):
        svc.set_camera_params(default_projection())
    for mask_stamp, depth_stamp, msg in published:
        mask, depth = raws[mask_stamp][0], raws[depth_stamp][1]
        a = sync.process_frame(mask, depth)
        b = jsvc.process_frame(mask, depth)
        assert a["found"] and b["found"]
        assert msg == a["message"]
        _same_message(b["message"], msg)


def test_ingest_host_only_record_has_the_jax_keys():
    rec = bench_service_ingest_torch.main(
        ["--host-only", "--device", "cpu", "--frames", "12"])
    want = _record_keys("tools/bench_service_ingest.py", "host_only")
    assert set(rec) == want | {"device"}
    # the bus keeps the newest pair, so a frame may be dropped
    assert 0 < rec["frames"] <= 12 and rec["value"] > 0


# ---- tools/bench_rerank_stability_torch.py ---------------------------------

def test_rerank_stability_run_mode_equals_jax_in_f32(monkeypatch):
    import jax.numpy as jnp
    from leafgrasp_tpu.vla import llava_jax as jl
    from leafgrasp_tpu.vla import llava_runtime as jr
    from leafgrasp_tpu_torch.vla import convert
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig)
    from tools import bench_rerank_stability as jtool

    jc = jl.LlavaJaxConfig(**TINY_LLAVA, dtype="float32")
    jmodel = jl.LlavaJax(jc)
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
        pixel_values=jnp.zeros((1, 28, 28, 3), jnp.float32))
    rng = np.random.default_rng(5)
    variables = jax.tree.map(
        lambda x: np.asarray(x) + 0.3 * rng.standard_normal(x.shape)
        .astype(np.float32), variables)
    tmodel = LlavaTorch(LlavaTorchConfig(**TINY_LLAVA, dtype="float32"),
                        device="cpu")
    tmodel.load_state_dict(convert.flax_to_torch_llava(variables))

    calls = []
    orig = jr.LlavaJaxScorer._score_batch

    def recording(self, rows, feats):
        out = orig(self, rows, feats)
        calls.append(list(out))
        return out

    monkeypatch.setattr(jr.LlavaJaxScorer, "_score_batch", recording)
    frames, seed = 2, 0
    want = jtool.run_mode("f32", jmodel, variables, frames, seed=seed)
    px = np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed + 77), (1, 28, 28, 3), jnp.float32))
    trace = []
    got = bench_rerank_stability_torch.run_mode(
        "f32", tmodel, frames, seed=seed, pixel_values=px.copy(),
        trace=trace)
    assert set(got) == set(want)
    # at these widths the stub tokenizer maps the prompt's "a" to the
    # image token (97 % 120 + 3 == 100), so a row holds more image tokens
    # than it has features and takes its neighbour's: both packages'
    # splices do, and the batchings part in both alike
    assert (got["candidates"], got["score_flips"]) == \
        (want["candidates"], want["score_flips"]) == (10, 10)
    np.testing.assert_allclose(got["max_first_step_dlogit_over_std"],
                               want["max_first_step_dlogit_over_std"],
                               rtol=1e-4)
    # JAX's calls: per frame one batch of 5, then 5 batches of one
    assert len(calls) == 6 * frames and len(trace) == frames
    for fi, (s_b, s_s) in enumerate(trace):
        chunk = calls[6 * fi:6 * fi + 6]
        assert s_b == chunk[0]
        assert s_s == [c[0] for c in chunk[1:]]


def test_rerank_stability_main_prints_the_jax_records():
    recs = bench_rerank_stability_torch.main(
        ["--tiny", "--device", "cpu", "--frames", "1", "--int8"])
    want = _record_keys("tools/bench_rerank_stability.py", "run_mode")
    assert [r["tag"] for r in recs] == ["bf16", "int8"]
    for rec in recs:
        assert set(rec) == want | {"device"}
        assert rec["candidates"] == 5 and rec["device"] == "cpu"


# ---- tools/bench_vla_service_torch.py --------------------------------------

def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_vla_service_tiny_degrades_and_writes_only_where_asked(tmp_path):
    jax_records = [os.path.join(ROOT, "artifacts", name) for name in
                   ("vla_service_bench.json",
                    "vla_service_bench_anyres.json")]
    before = {p: _digest(p) for p in jax_records}
    torch_dir = os.path.join(ROOT, "artifacts", "torch")
    listing = sorted(os.listdir(torch_dir))
    out = tmp_path / "rec.json"
    rec = bench_vla_service_torch.main(
        ["--tiny", "--device", "cpu", "--frame-size", "180", "240",
         "--frames", "2", "--json", "--out", str(out)])
    assert rec["inner_degradation_uniform_scores_ok"] is True
    assert rec["degraded_geometric_fallback_ok"] is True
    assert rec["vla_reranked_frames"] > 0 and rec["dims"] == "tiny"
    with open(jax_records[0]) as f:
        want = set(json.load(f))
    with open(out) as f:
        written = json.load(f)
    assert set(written) == set(rec) == want | {"device"}
    assert written["backend"] == "cpu" and written["device"] == "cpu"
    assert {p: _digest(p) for p in jax_records} == before
    assert sorted(os.listdir(torch_dir)) == listing
    # a tiny run writes nowhere by default, a full-width one to the
    # port's record only
    assert bench_vla_service_torch.record_path(None, True) is None
    assert bench_vla_service_torch.record_path(None, False) == \
        os.path.join(torch_dir, "vla_service_bench.json")
    assert bench_vla_service_torch.record_path("x.json", False) == "x.json"


# ---- the VLA latency tools -------------------------------------------------

def test_anyres_tool_record_has_the_jax_keys():
    rec = bench_vla_anyres_torch.main(
        ["--tiny", "--device", "cpu", "--frames", "1", "--stages",
         "--flash-ab"])
    src = "tools/bench_vla_anyres.py"
    tree = ast.parse(open(os.path.join(ROOT, src)).read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "dict"]
    keysets = [{k.arg for k in c.keywords} for c in calls]
    assert set(rec) == next(k for k in keysets if "mode" in k) | {"device"}
    assert set(rec["stages"]) == next(k for k in keysets
                                      if "prefill_ms" in k)
    assert set(rec["flash_ab"]) == next(k for k in keysets
                                        if "speedup" in k)
    assert rec["flash_ab"]["scores_match"] is True
    assert rec["mode"] == "anyres_bf16" and rec["packed_image_tokens"] > 4


@pytest.mark.parametrize("bits,storage,prefix",
                         [(8, "native", "int8"), (4, "packed", "int4p")])
def test_quant_tool_record_has_the_jax_keys(monkeypatch, bits, storage,
                                            prefix):
    from leafgrasp_tpu_torch.vla.llava_torch import LlavaTorchConfig
    monkeypatch.setattr(
        bench_vla_quant_torch, "model_config",
        lambda full, layers, hidden: LlavaTorchConfig(
            **{**TINY_LLAVA, "hidden": 256, "intermediate": 512,
               "heads": 2, "kv_heads": 1}, dtype="bfloat16"))
    rec = bench_vla_quant_torch.main(
        ["--device", "cpu", "--bits", str(bits), "--storage", storage])
    # bench_vla_quant.py:177-239: the bf16 and quantized readings and the
    # speedups, named by the quantized type
    want = {"metric", "dims", "step_speedup", "rerank_speedup",
            "bf16_weights_gb", "bf16_step_ms", "bf16_rerank_ms"} | {
        f"{prefix}_{k}" for k in ("weights_gb", "step_ms", "rerank_ms",
                                  "rerank_scan_ms")}
    assert set(rec) == want | {"device"}
    assert rec["metric"] == f"vla_serving_{prefix}_ab"
    assert rec[f"{prefix}_step_ms"] > 0 and rec["bf16_weights_gb"] is None


def test_vla_latency_tool_runs_tiny_on_the_cpu():
    rec = bench_vla_torch.main(["--tiny", "--device", "cpu"])
    assert rec["device"] == "cpu" and rec["prompt_tokens"] == 64
    assert rec["batched_rerank_ms"] > 0 and rec["sequential_rerank_ms"] > 0


def test_build_and_build_quantized_draw_the_init_random_state():
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     init_random_)
    from leafgrasp_tpu_torch.vla.quant import quantize_llava_variables
    cfg = LlavaTorchConfig(**TINY_LLAVA, dtype="bfloat16",
                           image_grid_pinpoints=((28, 56), (56, 28)))
    model = bench_vla_torch.build(cfg, seed=3, device="cpu")
    ref = LlavaTorch(cfg, device="cpu", param_dtype=torch.bfloat16)
    init_random_(ref, torch.Generator().manual_seed(3))
    got, want = model.state_dict(), ref.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.bfloat16
        if key != "image_newline":         # the JAX tools' numpy draw
            assert torch.equal(got[key], want[key]), key
    newline = 0.02 * np.random.default_rng(7).standard_normal(cfg.hidden)
    assert torch.equal(got["image_newline"],
                       torch.as_tensor(newline, dtype=torch.bfloat16))
    qmodel = bench_vla_torch.build_quantized(cfg, seed=3, device="cpu")
    qwant = quantize_llava_variables(got, bits=8)
    qgot = qmodel.state_dict()
    assert set(qgot) == set(qwant)
    for key in qwant:
        assert torch.equal(qgot[key], qwant[key]), key


# ---- every tool ------------------------------------------------------------

TOOLS = {"bench_torch": bench_torch,
         "bench_service_ingest_torch": bench_service_ingest_torch,
         "bench_vla_torch": bench_vla_torch,
         "bench_vla_anyres_torch": bench_vla_anyres_torch,
         "bench_vla_quant_torch": bench_vla_quant_torch,
         "bench_vla_service_torch": bench_vla_service_torch,
         "bench_rerank_stability_torch": bench_rerank_stability_torch,
         "micro_bench_frame_ab_torch": micro_bench_frame_ab_torch,
         "micro_bench_edt_ab_torch": micro_bench_edt_ab_torch,
         "micro_bench_batch_torch": micro_bench_batch_torch,
         "micro_bench_stages_torch": micro_bench_stages_torch}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_asked_for_the_card_without_one_raises(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TOOLS[name].main([])


def test_no_tool_imports_jax_or_the_jax_package():
    banned = ("jax", "flax", "optax", "orbax", "leafgrasp_tpu")
    for name, module in TOOLS.items():
        tree = ast.parse(open(module.__file__).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for mod in names:
                assert mod.split(".")[0] not in banned, (name, mod)
