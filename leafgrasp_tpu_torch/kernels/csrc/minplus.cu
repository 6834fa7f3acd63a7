// EDT pass-2 min-plus for Hopper:
//   out[r, q] = min over s in [lo, hi) of g2[r, s] + (qcol[q] - s)^2
//
// Replaces leafgrasp_tpu/ops/pallas_edt.py squared_edt_pass2 /
// _pass2_kernel (:65 / :41) and squared_edt_pass2_banded /
// _banded_kernel (:119 / :90), and serves every min-plus of
// leafgrasp_tpu/ops/edt.py (full sweep, banded sweep, query window,
// sampled envelope, refinement windows).
//
// Bound: operations. Each (row, query, source) triple costs a subtract,
// a multiply, an add and a min (2 counted operations: the add and the
// min), against 12 bytes of traffic per (row, query) pair; the full
// 1080 x 1440 x 1440 sweep is ~4.5 G operations over ~12 MB, far right
// of the ridge. Design: a block owns MP_ROWS rows x MP_QT query
// columns, one thread per query column holding MP_ROWS accumulators in
// registers; the rows' source columns are staged through shared memory
// MP_SC at a time and read as warp-wide broadcasts (no bank conflicts),
// so the inner loop is pure register arithmetic. A per-(row tile,
// query tile) band radius, in MP_QT-column chunks, narrows the sources
// to the chunks that can win (the banded form).
//
// All values are integer-valued f32 below 2^24, so every sum is exact
// and the result is bit-identical to any other evaluation order.

#include <cuda_runtime.h>
#include <math.h>

#define MP_ROWS 8
#define MP_QT 128
#define MP_SC 256

__global__ void __launch_bounds__(MP_QT)
minplus_pass2_kernel(const float* __restrict__ g2, int R, int W,
                     const int* __restrict__ qcol, int nq, int per_row,
                     int s_lo, int s_hi, const int* __restrict__ band,
                     int n_band_cols, float* __restrict__ out) {
  __shared__ float sg[MP_ROWS][MP_SC];
  const int qt = blockIdx.x;
  const int rt = blockIdx.y;
  const int q = qt * MP_QT + threadIdx.x;
  const int r0 = rt * MP_ROWS;
  const bool q_ok = q < nq;

  float qf[MP_ROWS];
  float acc[MP_ROWS];
#pragma unroll
  for (int r = 0; r < MP_ROWS; ++r) {
    const int rr = r0 + r;
    int qc = 0;
    if (q_ok && rr < R) {
      qc = per_row ? qcol[(size_t)rr * nq + q] : qcol[q];
    }
    qf[r] = (float)qc;
    acc[r] = INFINITY;
  }

  int lo = s_lo;
  int hi = s_hi;
  if (band != nullptr) {
    const int nb = band[rt * n_band_cols + qt];
    lo = max(lo, (qt - nb) * MP_QT);
    hi = min(hi, (qt + nb + 1) * MP_QT);
  }

  for (int s0 = lo; s0 < hi; s0 += MP_SC) {
    const int n = min(MP_SC, hi - s0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < MP_ROWS * MP_SC; idx += blockDim.x) {
      const int r = idx / MP_SC;
      const int s = idx - r * MP_SC;
      const int rr = r0 + r;
      sg[r][s] = (rr < R && s < n) ? g2[(size_t)rr * W + s0 + s] : INFINITY;
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float sf = (float)(s0 + s);
#pragma unroll
      for (int r = 0; r < MP_ROWS; ++r) {
        const float d = qf[r] - sf;
        acc[r] = fminf(acc[r], sg[r][s] + d * d);
      }
    }
  }

  if (q_ok) {
#pragma unroll
    for (int r = 0; r < MP_ROWS; ++r) {
      const int rr = r0 + r;
      if (rr < R) out[(size_t)rr * nq + q] = acc[r];
    }
  }
}

extern "C" int minplus_pass2(const float* g2, int R, int W, const int* qcol,
                             int nq, int per_row, int s_lo, int s_hi,
                             const int* band, int n_band_cols, float* out,
                             cudaStream_t stream) {
  if (R <= 0 || nq <= 0) return 0;
  dim3 grid((nq + MP_QT - 1) / MP_QT, (R + MP_ROWS - 1) / MP_ROWS);
  minplus_pass2_kernel<<<grid, MP_QT, 0, stream>>>(
      g2, R, W, qcol, nq, per_row, s_lo, s_hi, band, n_band_cols, out);
  return (int)cudaGetLastError();
}
