// Fused per-pixel grasp scoring for Hopper: one pass over the 7 input
// fields writes the 8 score maps and the valid mask.
//
// Replaces leafgrasp_tpu/ops/pallas_scoring.py fused_score_maps /
// _kernel (:130 / :40); the same formulas, term for term, so the
// wrapper's invalid-angle fallback (applied outside, as the JAX wrapper
// does at :209-223) composes the same way.
//
// Bound: bytes. Per pixel it reads 7 f32 and writes 8 f32 + 1 byte
// (61 bytes; 95 MB at 1080 x 1440, 28 us at 3.35 TB/s) and does ~60
// flops plus two expf and two sqrtf. Design: one thread per pixel, rows
// on the grid's y axis, neighbouring threads on neighbouring columns so
// every load and store is coalesced; the 11 frame scalars and 17 config
// weights are read once per thread from two tiny device arrays (cached
// in L1), so the kernel makes exactly one pass over device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// scalar layout (matches the Python wrapper and pallas_scoring.py)
enum { S_CX, S_CY, S_F, S_SIN, S_COS, S_MAXSDF, S_MAXCLOSE, S_MAXWIDE,
       S_H, S_W, S_ROW0 };
// config weight layout (matches kernels/scoring.py _weights)
enum { W_OPT, W_INT, W_ALIGN, W_RAW, W_FLAT_SCALE, W_ISO_CLOSE, W_ISO_WIDE,
       W_PREF_TOP, W_PREF_SLOPE, W_ACC_DIST, W_ACC_DIR, W_APPROACH, W_SDF,
       W_FLAT, W_ACCESS, W_MIN_EDGE, W_STEM_CUT };

#define SC_THREADS 256

__global__ void __launch_bounds__(SC_THREADS)
fused_score_maps_kernel(const float* __restrict__ din,
                        const float* __restrict__ dout,
                        const float* __restrict__ dclose,
                        const float* __restrict__ dwide,
                        const float* __restrict__ grad,
                        const float* __restrict__ mask,
                        const float* __restrict__ stem_in,
                        const float* __restrict__ scal,
                        const float* __restrict__ wt, int H, int W,
                        float* __restrict__ sdf_o, float* __restrict__ app_o,
                        float* __restrict__ flat_o, float* __restrict__ iso_o,
                        float* __restrict__ dist_o,
                        float* __restrict__ acc_o,
                        float* __restrict__ stem_o,
                        float* __restrict__ trad_o,
                        uint8_t* __restrict__ valid_o) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)y * W + x;

  const float cx = scal[S_CX], cy = scal[S_CY], f = scal[S_F];
  const float sin_a = scal[S_SIN], cos_a = scal[S_COS];
  const float max_sdf = scal[S_MAXSDF];
  const float max_close = scal[S_MAXCLOSE], max_wide = scal[S_MAXWIDE];
  const float h = scal[S_H], w = scal[S_W], row0 = scal[S_ROW0];

  const float ys = row0 + (float)y;
  const float xs = (float)x;

  const float m = mask[i];
  const float d_in = din[i];
  const float d_out = dout[i];
  const float stem = stem_in[i];

  // sdf_score (grasp_point_selector.py:526-567)
  const float opt = wt[W_OPT];
  const float t = d_in - opt;
  const float interior = expf(-(t * t) / (2.0f * opt * opt));
  const float sdf = (d_in - d_out) / max_sdf;
  const float vx = xs - cx;
  const float vy = ys - cy;
  float norm2d = sqrtf(vx * vx + vy * vy);
  norm2d = norm2d == 0.0f ? 1.0f : norm2d;
  const float align = fabsf((vx * sin_a - vy * cos_a) / norm2d);
  const float sdf_score = (wt[W_INT] * interior + wt[W_ALIGN] * align
                           + wt[W_RAW] * sdf) * m;

  // approach (grasp_point_selector.py:569-593)
  const float norm3d = sqrtf(vx * vx + vy * vy + f * f);
  const float approach = (f / norm3d) * m;

  // flatness (grasp_point_selector.py:635-657)
  const float flat = expf(-grad[i] * wt[W_FLAT_SCALE]);

  // isolation (grasp_point_selector.py:595-633)
  const float iso = wt[W_ISO_CLOSE] * dclose[i] / (max_close + 1e-6f)
                    + wt[W_ISO_WIDE] * dwide[i] / (max_wide + 1e-6f);
  const float pref = wt[W_PREF_TOP] + wt[W_PREF_SLOPE] * ys / (h - 1.0f);
  const float isolation = iso * pref * m;

  // distance / accessibility / stem
  const float dist = d_in * m;
  const float max_dist = sqrtf(w * w + h * h);
  const float access = (wt[W_ACC_DIST] * (1.0f - norm2d / max_dist)
                        + wt[W_ACC_DIR] * (vx / norm2d)) * m;

  const float trad = (wt[W_APPROACH] * approach + wt[W_SDF] * sdf_score
                      + wt[W_FLAT] * flat + wt[W_ACCESS] * access)
                     * (1.0f - stem);
  const bool valid = (dist > wt[W_MIN_EDGE]) && (m > 0.5f)
                     && (stem < wt[W_STEM_CUT]);

  sdf_o[i] = sdf_score;
  app_o[i] = approach;
  flat_o[i] = flat;
  iso_o[i] = isolation;
  dist_o[i] = dist;
  acc_o[i] = access;
  stem_o[i] = stem;
  trad_o[i] = trad;
  valid_o[i] = valid ? 1 : 0;
}

extern "C" int fused_score_maps(const float* din, const float* dout,
                                const float* dclose, const float* dwide,
                                const float* grad, const float* mask,
                                const float* stem, const float* scal,
                                const float* wt, int H, int W, float* sdf_o,
                                float* app_o, float* flat_o, float* iso_o,
                                float* dist_o, float* acc_o, float* stem_o,
                                float* trad_o, uint8_t* valid_o,
                                cudaStream_t stream) {
  if (H <= 0 || W <= 0) return 0;
  dim3 grid((W + SC_THREADS - 1) / SC_THREADS, H);
  fused_score_maps_kernel<<<grid, SC_THREADS, 0, stream>>>(
      din, dout, dclose, dwide, grad, mask, stem, scal, wt, H, W, sdf_o,
      app_o, flat_o, iso_o, dist_o, acc_o, stem_o, trad_o, valid_o);
  return (int)cudaGetLastError();
}
