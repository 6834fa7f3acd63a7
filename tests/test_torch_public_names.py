"""The JAX package's public names that the port carries as thin names
over what it already computes, each against the JAX function on the same
numpy inputs on the CPU.

Bit-equal where the arithmetic is the same: the rectangle and Gaussian
kernels' shapes and the Sobel constants, the median's bisection with an
explicit range, the dilated vertical distances (int32), the valid
region. The 2D reflect convolution sums its taps in another order than
XLA's convolution: 1e-6 absolute on values of order one. The Gaussian
kernel is the outer product of the f32 1D factor, JAX's the 2D formula
rounded once to f32: one f32 ulp (2^-23 relative). The seeded CNN
initialization draws other random numbers than Flax: same names and
shapes, BatchNorm statistics and biases equal, and each kernel's
deviation within 15% of the Flax initializer's. The device quantizer: codes within one of JAX's device
variant, scales one f32 ulp (2^-23 relative) of it.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leafgrasp_tpu.config import ModelConfig as JModelConfig
from leafgrasp_tpu.geometry import grasp_scorer as jgs
from leafgrasp_tpu.io.scenes import make_leaf_scene
from leafgrasp_tpu.models import grasp_cnn as jcnn
from leafgrasp_tpu.ops import components as jcomp
from leafgrasp_tpu.ops import conv as jconv
from leafgrasp_tpu.ops import morphology as jmorph
from leafgrasp_tpu.vla import llava_jax as jl
from leafgrasp_tpu.vla import quant as jq
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from leafgrasp_tpu_torch.config import ModelConfig
from leafgrasp_tpu_torch.geometry import grasp_scorer as tgs
from leafgrasp_tpu_torch.models import grasp_cnn as tcnn
from leafgrasp_tpu_torch.models.convert import flax_to_torch_grasp_cnn
from leafgrasp_tpu_torch.ops import components as tcomp
from leafgrasp_tpu_torch.ops import conv as tconv
from leafgrasp_tpu_torch.ops import edt as tedt
from leafgrasp_tpu_torch.ops import morphology as tmorph
from leafgrasp_tpu_torch.vla import convert
from leafgrasp_tpu_torch.vla import quant as tq

# the package exports a function named edt beside its module
jedt = importlib.import_module("leafgrasp_tpu.ops.edt")
CAMERA = (np.float32(180.0), np.float32(135.0), np.float32(800.0))


def _scene(seed=3, h=96, w=160):
    mask, depth = make_leaf_scene(h, w, num_leaves=4, seed=seed, margin=16)
    return mask.astype(np.int32), depth


@pytest.mark.parametrize("size", [(3, None), (5, 7), (21, 9)])
def test_rect_kernel_matches_jax(size):
    got = tmorph.rect_kernel(*size)
    want = jmorph.rect_kernel(*size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [3, 5, 9])
def test_gaussian_kernel_matches_jax(size):
    got, want = tconv.gaussian_kernel(size), jconv.gaussian_kernel(size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=0)
    assert abs(float(got.sum()) - 1.0) < 1e-6


def test_sobel_constants_match_jax():
    for got, want in ((tconv.SOBEL_X, jconv.SOBEL_X),
                      (tconv.SOBEL_Y, jconv.SOBEL_Y)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", ["sobel_x", "sobel_y", "gauss5",
                                    "ragged"])
def test_reflect_conv2d_matches_jax(kernel):
    k = {"sobel_x": jconv.SOBEL_X, "sobel_y": jconv.SOBEL_Y,
         "gauss5": jconv.gaussian_kernel(5),
         "ragged": np.random.default_rng(2).normal(size=(3, 5))
         .astype(np.float32)}[kernel]
    _, depth = _scene()
    want = np.asarray(jconv.reflect_conv2d(jnp.asarray(depth), k))
    got = tconv.reflect_conv2d(torch.from_numpy(depth), k).numpy()
    assert got.shape == want.shape == depth.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_masked_median_range_matches_jax():
    mask, depth = _scene(seed=5)
    num = 6
    counts = np.bincount(mask.ravel(), minlength=num).astype(np.int32)
    dmin, dmax = float(depth.min()) - 0.1, float(depth.max()) + 0.2
    want = np.asarray(jcomp.masked_median_range(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(counts), num,
        jnp.float32(dmin), jnp.float32(dmax)))
    got = tcomp.masked_median_range(
        torch.from_numpy(depth), torch.from_numpy(mask),
        torch.from_numpy(counts), num, torch.tensor(np.float32(dmin)),
        torch.tensor(np.float32(dmax))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", [(7, 7), (15, 9), (21, 21)])
def test_dilated_vertical_dist_matches_jax(kernel):
    mask, _ = _scene(seed=7)
    se = jmorph.elliptical_kernel(*kernel)
    jup, jdn = jedt.directional_seed_dist_1d(jnp.asarray(mask == 2), axis=0)
    want = np.asarray(jmorph.dilated_vertical_dist(jup, jdn, se))
    tup, tdn = tedt.directional_seed_dist_1d(torch.from_numpy(mask == 2),
                                             axis=0)
    got = tmorph.dilated_vertical_dist(tup, tdn, se).numpy()
    np.testing.assert_array_equal(got, want)


def test_valid_grasp_region_matches_jax():
    mask, depth = make_leaf_scene(270, 360, num_leaves=4, seed=0, margin=40)
    leaf, all_m = mask == 2, mask > 0
    want = np.asarray(jgs.valid_grasp_region(jgs.compute_grasp_scores(
        jnp.asarray(leaf), jnp.asarray(all_m), jnp.asarray(depth),
        *CAMERA)))
    got = tgs.valid_grasp_region(tgs.compute_grasp_scores(
        torch.from_numpy(leaf), torch.from_numpy(all_m),
        torch.from_numpy(depth), *CAMERA)).numpy()
    assert got.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["lightweight", "standard"])
def test_init_grasp_cnn_matches_flax_init(arch):
    filters = tcnn.ARCHITECTURES[arch]
    _, jvars = jcnn.init_grasp_cnn(jax.random.PRNGKey(0), JModelConfig(
        encoder_filters=filters))
    want = flax_to_torch_grasp_cnn(jax.tree.map(np.asarray, jvars))
    model, state = tcnn.init_grasp_cnn(seed=0, cfg=ModelConfig(
        encoder_filters=filters))
    assert isinstance(model, tcnn.GraspPointCNN)
    assert set(state) == set(want)
    again = tcnn.init_grasp_cnn(seed=0, cfg=ModelConfig(
        encoder_filters=filters))[1]
    for k, w in want.items():
        got = state[k]
        assert got.shape == w.shape, k
        assert torch.equal(got, again[k]), k
        if got.dim() >= 2:
            ratio = float(got.float().std()) / float(w.float().std())
            assert abs(ratio - 1.0) < 0.15, (k, ratio)
        else:        # biases, BatchNorm scale / bias / statistics
            assert torch.equal(got, w.to(got.dtype)), k


def test_quantize_llava_variables_device_matches_jax():
    tiny = dict(vis_hidden=32, vis_intermediate=64, vis_layers=2,
                vis_heads=2, image_size=28, patch_size=14, vocab_size=128,
                hidden=32, intermediate=64, layers=2, heads=4, kv_heads=2,
                image_token_index=100)
    model = jl.LlavaJax(jl.LlavaJaxConfig(**tiny))
    variables = model.init(jax.random.PRNGKey(4),
                           jnp.zeros((1, 8), jnp.int32),
                           pixel_values=jnp.zeros((1, 28, 28, 3)))
    state = convert.flax_to_torch_llava(variables)
    box = [dict(state)]
    got = tq.quantize_llava_variables_device(box, bits=8)
    assert box == []
    want = convert.flax_to_torch_llava(
        jq.quantize_llava_variables_device([variables], bits=8))
    assert set(got) == set(want)
    n_q = 0
    for k, w in want.items():
        if k.endswith("kernel_q"):
            n_q += 1
            d = (got[k].to(torch.int32) - w.to(torch.int32)).abs()
            assert int(d.max()) <= 1, k
        elif k.endswith("kernel_scale"):
            torch.testing.assert_close(got[k], w, rtol=2.0 ** -23, atol=0)
        else:
            assert torch.equal(got[k], w), k
    assert n_q == 7 * tiny["layers"] + 1      # the projections, lm_head
    with pytest.raises(ValueError):
        tq.quantize_llava_variables_device([got], bits=4)
