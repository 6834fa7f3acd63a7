"""The port's mesh, sharding rules, spatial primitives and batched frame
(leafgrasp_tpu_torch/parallel/) against the JAX package's, as
tests/test_parallel.py holds the JAX ones.

The JAX side runs in this process on its virtual 8-device CPU mesh; the
port's runs on spawned gloo CPU ranks (tests/_torch_dist.py), 8 for the
mesh and sharding rules and 4 for the rest, each spawn serving several
tests through a module fixture. Rank functions are module-level and this
module imports no JAX at the top, so the ranks import it without JAX.
Tolerances: integer results and the squared EDT equal, the EDT 1e-6
relative / 1e-5 absolute (JAX's own), the batched frame's floats 1e-5
absolute.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._torch_dist import spawn
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHIFTS = (3, -3, 0, 12, -12)
VLA_CFG = dict(dim=32, n_layers=1, n_heads=2, n_kv_heads=1, mlp_hidden=64,
               vision_tokens=2, vision_patch=16, lora_rank=4)
BATCH = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUN_PATHS = ("CNN dp+tp train step", "dp batched pipeline",
                "row-sharded full-frame pipeline", "tp VLA LoRA step",
                "tp LLaVA forward", "tp LLaVA padded-batch generate",
                "tp int8-quantized LLaVA generate",
                "tp int4 group-quantized LLaVA generate",
                "pp LLaVA forward (2 stages", "pp x tp LLaVA forward",
                "pp LoRA training step (2 stages, remat)",
                "tp anyres LLaVA-NeXT generate")


def _scene(h, w, n, seed, margin):
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    return make_leaf_scene(height=h, width=w, num_leaves=n, seed=seed,
                           margin=margin)


def _batch_cfg(pkg):
    return pkg.PipelineConfig(
        frame=pkg.FrameConfig(height=96, width=128, max_leaves=4),
        leaf=pkg.LeafSelectionConfig(min_leaf_area=200))


def _batch_frames():
    mask, depth = _scene(96, 128, 3, 1, 16)
    return (np.stack([np.roll(mask, i, 1) for i in range(BATCH)]),
            np.stack([np.roll(depth, i, 1) for i in range(BATCH)]))


# ------------------------------------------------------------ rank bodies --

def _mesh_ranks(rank, world):
    """8 ranks: mesh shapes, the rejection, the sharding rules and the
    DTensor layouts."""
    from torch.distributed.tensor import Shard
    from leafgrasp_tpu_torch.parallel import (infer_param_shardings,
                                              make_mesh, shard_batch,
                                              shard_variables)
    from leafgrasp_tpu_torch.parallel.mesh import mesh_shape
    from leafgrasp_tpu_torch.vla.convert import torch_to_flax_tiny_vla
    from leafgrasp_tpu_torch.vla.lm import VLAModelConfig, init_vla

    out = {}
    try:
        make_mesh(6, model_axis=4, device="cpu")
        out["reject"] = None
    except ValueError as exc:
        out["reject"] = str(exc)
    try:
        make_mesh(4, model_axis=2, device="cpu")
        out["reject_size"] = None
    except ValueError as exc:
        out["reject_size"] = str(exc)
    mesh = make_mesh(8, model_axis=2, device="cpu")
    out["shape"] = mesh_shape(mesh)
    state = init_vla(0, VLAModelConfig(**VLA_CFG), device="cpu").state_dict()

    def flax_name(key):
        return next(iter(torch_to_flax_tiny_vla({key: state[key]})))
    specs = infer_param_shardings(state, mesh, flax_name)
    out["specs"] = {flax_name(k): (None if not isinstance(p[1], Shard)
                                   else p[1].dim)
                    for k, p in specs.items()}
    sharded, _ = shard_variables(state, mesh, flax_name)
    out["roundtrip"] = all(torch.equal(sharded[k].full_tensor(), v)
                           for k, v in state.items())
    out["local_q"] = tuple(
        sharded["layers.0.attn.q_proj.base.weight"].to_local().shape)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    (bx,) = shard_batch((x,), mesh)
    out["batch"] = (tuple(bx.to_local().shape),
                    torch.equal(bx.full_tensor(), x))
    return out


def _spatial_ranks(rank, world, seeds_nearest, seeds_edt, arr, masks,
                   depths):
    """4 ranks: the sharded nearest-seed rows, EDT, row shifts and the
    batched frame."""
    import leafgrasp_tpu_torch.config as tcfg
    from leafgrasp_tpu_torch.parallel import (make_batched_frame_fn,
                                              make_mesh, sharded_edt,
                                              sharded_nearest_seed_rows,
                                              sharded_shift_rows,
                                              sharded_squared_edt)
    from leafgrasp_tpu_torch.utils.device import fetch_to_host

    mesh = make_mesh(device="cpu")
    out = {"nearest": sharded_nearest_seed_rows(seeds_nearest, mesh)
           .full_tensor().numpy(),
           "edt": sharded_edt(seeds_edt, mesh).full_tensor().numpy(),
           "squared_edt": sharded_squared_edt(seeds_edt, mesh)
           .full_tensor().numpy(),
           "shift": {dy: sharded_shift_rows(arr, dy, -1.0, mesh)
                     .full_tensor().numpy() for dy in SHIFTS}}
    fn = make_batched_frame_fn(mesh, _batch_cfg(tcfg), with_cnn=False)
    res = fn(masks, depths, np.float32(64.0), np.float32(48.0),
             np.float32(200.0))
    out["batched"] = fetch_to_host(res)
    out["batched_calls"] = fn.axis.calls
    try:
        fn(masks[:3], depths[:3], 64.0, 48.0, 200.0)
        out["batched_reject"] = None
    except ValueError as exc:
        out["batched_reject"] = str(exc)
    return out


# --------------------------------------------------------------- fixtures --

@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    return spawn(_mesh_ranks, 8, tmp_path_factory.mktemp("mesh"))


@pytest.fixture(scope="module")
def spatial_inputs():
    near, _ = _scene(96, 64, 3, 2, 12)
    edt_mask, _ = _scene(96, 64, 3, 4, 12)
    arr = np.arange(96 * 8, dtype=np.float32).reshape(96, 8)
    masks, depths = _batch_frames()
    return near > 0, edt_mask > 0, arr, masks, depths


@pytest.fixture(scope="module")
def spatial_results(tmp_path_factory, spatial_inputs):
    return spawn(_spatial_ranks, 4, tmp_path_factory.mktemp("spatial"),
                 *spatial_inputs)


# ------------------------------------------------------------------ tests --

def test_mesh_shapes_and_rejection(mesh_results):
    for out in mesh_results:
        assert out["shape"] == {"data": 4, "model": 2}
        assert "not divisible" in out["reject"]
        assert "process group of 8" in out["reject_size"]


def test_make_mesh_needs_cuda_and_a_group(monkeypatch):
    from leafgrasp_tpu_torch.parallel import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")


def test_param_shardings_match_jax(mesh_results):
    import jax
    from leafgrasp_tpu.parallel.mesh import make_mesh as j_make_mesh
    from leafgrasp_tpu.parallel.sharding import infer_param_shardings
    from leafgrasp_tpu.vla.lm import VLAModelConfig, init_vla

    _, variables = init_vla(jax.random.PRNGKey(0), VLAModelConfig(**VLA_CFG))
    shardings = infer_param_shardings(variables["params"],
                                      j_make_mesh(8, model_axis=2))
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        spec = tuple(s.spec)
        want[key] = spec.index("model") if "model" in spec else None
    # the Flax dim sharded -> the port's: a Linear weight is transposed
    got = {}
    for key, dim in mesh_results[0]["specs"].items():
        if dim is not None and key.endswith("/kernel"):
            dim = 1 - dim
        got[key] = dim
    assert got == want
    assert sum(d is not None for d in want.values()) >= 10
    for out in mesh_results:
        assert out["specs"] == mesh_results[0]["specs"]


def test_shard_variables_and_batch_layouts(mesh_results):
    for out in mesh_results:
        assert out["roundtrip"]
        assert out["local_q"] == (16, 32)      # (out / model, in)
        assert out["batch"] == ((2, 3), True)  # 8 rows over data = 4


def test_sharded_nearest_seed_matches(spatial_results, spatial_inputs):
    from leafgrasp_tpu.ops.edt import nearest_seed_dist_1d as j_nearest
    from leafgrasp_tpu_torch.ops.edt import nearest_seed_dist_1d
    seeds = spatial_inputs[0]
    ref = np.asarray(j_nearest(seeds, axis=0))
    finite = ref < 96 + 64
    for out in spatial_results:
        ours = out["nearest"]
        np.testing.assert_array_equal(ours[finite], ref[finite])
        np.testing.assert_array_equal(
            ours, nearest_seed_dist_1d(torch.from_numpy(seeds), 0).numpy())


def test_sharded_edt_matches_jax(spatial_results, spatial_inputs):
    from leafgrasp_tpu.ops.edt import edt
    ref = np.asarray(edt(spatial_inputs[1]))
    for out in spatial_results:
        np.testing.assert_allclose(out["edt"], ref, rtol=1e-6, atol=1e-5)


def test_sharded_squared_edt_bit_equals_jax(spatial_results, spatial_inputs):
    """Exact squared distances: equal to JAX's unsharded ``squared_edt``
    and to its ``sharded_squared_edt`` on the 8-device mesh."""
    from leafgrasp_tpu.ops.edt import squared_edt
    from leafgrasp_tpu.parallel.mesh import make_mesh as j_make_mesh
    from leafgrasp_tpu.parallel.spatial import sharded_squared_edt
    seeds = spatial_inputs[1]
    ref = np.asarray(squared_edt(seeds))
    np.testing.assert_array_equal(
        np.asarray(sharded_squared_edt(seeds, j_make_mesh(8, model_axis=1))),
        ref)
    for out in spatial_results:
        np.testing.assert_array_equal(out["squared_edt"], ref)


@pytest.mark.parametrize("dy", SHIFTS)
def test_sharded_shift_rows(spatial_results, spatial_inputs, dy):
    arr = spatial_inputs[2]
    expected = np.full_like(arr, -1.0)
    if dy > 0:
        expected[:-dy] = arr[dy:]
    elif dy < 0:
        expected[-dy:] = arr[:dy]
    else:
        expected = arr
    for out in spatial_results:
        np.testing.assert_array_equal(out["shift"][dy], expected)


def test_batched_frame_matches_jax(spatial_results, spatial_inputs):
    import leafgrasp_tpu.config as jcfg
    from leafgrasp_tpu.pipeline.frame import make_frame_fn
    masks, depths = spatial_inputs[3], spatial_inputs[4]
    single = make_frame_fn(_batch_cfg(jcfg), with_cnn=False)
    for out in spatial_results:
        res = out["batched"]
        assert res.grasp_uv.shape == (BATCH, 2)
        assert res.candidates.x.shape[0] == BATCH
        assert out["batched_calls"] == 1
        assert "must divide" in out["batched_reject"]
    res = spatial_results[0]["batched"]
    for i in range(BATCH):
        r = single(masks[i], depths[i], np.float32(64.0), np.float32(48.0),
                   np.float32(200.0))
        assert int(r.leaf_id) == int(res.leaf_id[i])
        np.testing.assert_array_equal(np.asarray(r.grasp_uv),
                                      res.grasp_uv[i])
        np.testing.assert_array_equal(np.asarray(r.candidates.x),
                                      res.candidates.x[i])
        np.testing.assert_allclose(np.asarray(r.grasp_xyz),
                                   res.grasp_xyz[i], rtol=0, atol=1e-5)
        assert bool(r.found) == bool(res.found[i])


def test_dryrun_tool_runs_on_four_cpu_ranks():
    proc = subprocess.run(
        [sys.executable, "tools/dryrun_parallel_torch.py", "--ranks", "4",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert '"ok": true' in lines[-1], proc.stdout[-3000:]
    # one line a path of dryrun_multichip, 1 to 11, in its order
    for line, words in zip(lines[:-1], DRYRUN_PATHS):
        assert line.endswith("OK") and words in line, (line, words)
    assert len(lines) == len(DRYRUN_PATHS) + 1, proc.stdout[-3000:]
