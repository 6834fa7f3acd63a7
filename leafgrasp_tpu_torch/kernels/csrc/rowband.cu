// Row-banded EDT pass 2 for Hopper:
//   out[c, i, j] = min over i' of g2r[c, i', j] + (i - i')^2
// where each RB_ROWS x RB_COLS output tile visits only the candidate
// rows within its own radius nb of the tile.
//
// Replaces leafgrasp_tpu/ops/pallas_edt.py squared_edt_rowband /
// _rowband_kernel (:215 / :175), radii included (:243-255).
//
// Bound: operations. Each (output, candidate row) pair inside a tile's
// band costs an add and a min (2 counted operations; the kernel issues
// an add for the offset, a fused multiply-add and a min), against 8
// bytes per pixel of traffic. Design:
// the TPU kernel keeps a whole column stripe resident in fast memory;
// here a block owns one tile, one thread per column with RB_ROWS
// accumulators in registers, and walks the candidate rows: a row of
// candidates is one coalesced load shared by the tile's RB_ROWS output
// rows, with no staging in shared memory. At half resolution a frame has
// only some 400 tiles, and the tiles far from any seed walk every row,
// so a block has RB_SLICES slices of threads: slice s takes the
// candidate rows lo + s, lo + s + RB_SLICES, ..., and the slices' partial
// minima meet in shared memory. That multiplies the warps in flight and
// divides the longest walk by RB_SLICES (8 was the fastest of 1, 2, 4
// and 8 measured on an H100; PERF.md has the sweep).
//
// The radii come from two small prologue kernels: a min-pool over each
// tile's rows, then a min-plus at 1/RB_ROWS row resolution with the
// offset (RB_ROWS (|I - I'| + 1))^2, which bounds every output of row
// tile I from above; nb = floor(sqrt(tile max)) + 1. Any pointwise upper
// bound keeps the result exact: the winning row i* has
// (i - i*)^2 <= out <= bound <= nb^2.
//
// All values are integer-valued f32 below 2^24, so every sum is exact
// and the result is bit-identical to any other evaluation order.

#include <cuda_runtime.h>
#include <math.h>

#define RB_ROWS 8
#define RB_COLS 128

// g2c[c, I, j] = min of g2r[c, i, j] over the rows i of row tile I
__global__ void rowband_pool_kernel(const float* __restrict__ g2r, int H,
                                    int W, int RT, float* __restrict__ g2c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int I = blockIdx.y;
  const int c = blockIdx.z;
  if (j >= W) return;
  const int n = min(RB_ROWS, H - I * RB_ROWS);
  const float* src = g2r + ((size_t)c * H + (size_t)I * RB_ROWS) * W + j;
  float m = INFINITY;
  for (int r = 0; r < n; ++r) m = fminf(m, src[(size_t)r * W]);
  g2c[((size_t)c * RT + I) * W + j] = m;
}

// nb[c, I, ct] = floor(sqrt(max over the tile's columns of
//   min over I' of g2c[c, I', j] + (RB_ROWS (|I - I'| + 1))^2)) + 1
__global__ void __launch_bounds__(RB_COLS)
rowband_radius_kernel(const float* __restrict__ g2c, int H, int W, int RT,
                      int CT, int* __restrict__ nb) {
  __shared__ float smax[RB_COLS / 32];
  const int ct = blockIdx.x;
  const int I = blockIdx.y;
  const int c = blockIdx.z;
  const int j = ct * RB_COLS + threadIdx.x;
  float u = 0.0f;                 // columns past W bound nothing
  if (j < W) {
    u = INFINITY;
    const float* col = g2c + (size_t)c * RT * W + j;
    for (int k = 0; k < RT; ++k) {
      const float d = (float)((abs(I - k) + 1) * RB_ROWS);
      u = fminf(u, col[(size_t)k * W] + d * d);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    u = fmaxf(u, __shfl_xor_sync(0xffffffffu, u, off));
  if ((threadIdx.x & 31) == 0) smax[threadIdx.x >> 5] = u;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = smax[0];
    for (int k = 1; k < RB_COLS / 32; ++k) m = fmaxf(m, smax[k]);
    nb[((size_t)c * RT + I) * CT + ct] = min((int)sqrtf(m) + 1, H);
  }
}

#define RB_SLICES 8   // thread slices that share a tile's candidate rows

// blockDim = (RB_COLS, RB_SLICES)
__global__ void __launch_bounds__(RB_COLS * RB_SLICES)
rowband_kernel(const float* __restrict__ g2r, int H, int W, int RT, int CT,
               const int* __restrict__ nb, float* __restrict__ out) {
  __shared__ float part[RB_SLICES * RB_ROWS * RB_COLS];
  const int ct = blockIdx.x;
  const int I = blockIdx.y;
  const int c = blockIdx.z;
  const int ty = threadIdx.y;
  const int j = ct * RB_COLS + threadIdx.x;
  const bool j_ok = j < W;
  const int row0 = I * RB_ROWS;
  const int r = nb[((size_t)c * RT + I) * CT + ct];
  const int lo = max(row0 - r, 0);
  const int hi = min(row0 + RB_ROWS - 1 + r, H - 1);

  float acc[RB_ROWS];
#pragma unroll
  for (int k = 0; k < RB_ROWS; ++k) acc[k] = INFINITY;

  if (j_ok) {
    const float* col = g2r + (size_t)c * H * W + j;
#pragma unroll 4
    for (int i = lo + ty; i <= hi; i += RB_SLICES) {
      const float v = col[(size_t)i * W];
      const float d = (float)(row0 - i);
#pragma unroll
      for (int k = 0; k < RB_ROWS; ++k) {
        const float dk = d + (float)k;
        // integers below 2^24: the fused form rounds nowhere, so it is
        // the plain version's v + dk * dk bit for bit
        acc[k] = fminf(acc[k], __fmaf_rn(dk, dk, v));
      }
    }
  }

#pragma unroll
  for (int k = 0; k < RB_ROWS; ++k)
    part[(ty * RB_ROWS + k) * RB_COLS + threadIdx.x] = acc[k];
  __syncthreads();
  // slice ty finishes the output rows ty, ty + RB_SLICES, ...
  if (!j_ok) return;
  for (int k = ty; k < RB_ROWS; k += RB_SLICES) {
    if (row0 + k >= H) break;
    float m = part[k * RB_COLS + threadIdx.x];
    for (int s = 1; s < RB_SLICES; ++s)
      m = fminf(m, part[(s * RB_ROWS + k) * RB_COLS + threadIdx.x]);
    out[((size_t)c * H + row0 + k) * W + j] = m;
  }
}

// g2c: (C, RT, W) f32 scratch; nb: (C, RT, CT) int32, written here.
extern "C" int squared_edt_rowband(const float* g2r, int C, int H, int W,
                                   float* g2c, int* nb, float* out,
                                   cudaStream_t stream) {
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  const int RT = (H + RB_ROWS - 1) / RB_ROWS;
  const int CT = (W + RB_COLS - 1) / RB_COLS;
  dim3 grid(CT, RT, C);
  rowband_pool_kernel<<<grid, RB_COLS, 0, stream>>>(g2r, H, W, RT, g2c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rowband_radius_kernel<<<grid, RB_COLS, 0, stream>>>(g2c, H, W, RT, CT, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rowband_kernel<<<grid, dim3(RB_COLS, RB_SLICES), 0, stream>>>(
      g2r, H, W, RT, CT, nb, out);
  return (int)cudaGetLastError();
}
