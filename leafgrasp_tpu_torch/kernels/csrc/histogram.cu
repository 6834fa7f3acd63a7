// Per-segment 256-bin histogram for Hopper:
//   out[id, bin] += 1 for every pixel with 0 <= id < num, where
//   bin = (int)clip((depth - lo[id]) * inv_w[id], 0, 255)
//
// Replaces leafgrasp_tpu/ops/pallas_median.py segment_histogram /
// _hist_kernel (:76 / :31).
//
// Bound: bytes. A pixel is 8 bytes read (f32 depth, int32 id) and a few
// operations; the (num, 256) counts are a few KB. Design: the TPU kernel
// counts with one-hot matrix products because the TPU has no scatter;
// here each block keeps a (num, 256) int32 histogram in shared memory,
// walks its pixels with a grid-stride loop, and adds with shared-memory
// atomics. Neighbouring pixels mostly share a leaf and a bin, so the
// lanes of a warp that hold the same key are matched first and one lane
// adds their count: one atomic per distinct key per warp. A block
// flushes each non-zero bin with one global atomic. Integer counts make
// the result independent of the order of the adds.
//
// The bin is a separate subtract and multiply in f32 (the build passes
// -fmad=false), clipped before the cast, as the plain version computes
// it: a fused multiply-add or a cast before the clip would move pixels
// on a bin edge to the next bin.

#include <cuda_runtime.h>

#define HIST_BINS 256
#define HIST_THREADS 256

__global__ void __launch_bounds__(HIST_THREADS)
segment_histogram_kernel(const float* __restrict__ depth,
                         const int* __restrict__ ids,
                         const float* __restrict__ lo,
                         const float* __restrict__ inv_w, int n, int num,
                         int* __restrict__ out) {
  extern __shared__ int hist[];               // (num, HIST_BINS)
  const int cells = num * HIST_BINS;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int stride = gridDim.x * blockDim.x;
  // ``base`` is the same for every thread of the block, so all 32 lanes
  // of a warp reach the match together
  for (int base = blockIdx.x * blockDim.x; base < n; base += stride) {
    const int p = base + threadIdx.x;
    int key = -1;
    if (p < n) {
      const int id = ids[p];
      if (id >= 0 && id < num) {
        float b = (depth[p] - lo[id]) * inv_w[id];
        b = fminf(fmaxf(b, 0.0f), (float)(HIST_BINS - 1));
        key = id * HIST_BINS + (int)b;
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&hist[key], __popc(peers));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int v = hist[i];
    if (v != 0) atomicAdd(&out[i], v);
  }
}

// out: (num, HIST_BINS) int32, zeroed by the caller.
extern "C" int segment_histogram(const float* depth, const int* ids,
                                 const float* lo, const float* inv_w, int n,
                                 int num, int blocks, int* out,
                                 cudaStream_t stream) {
  if (n <= 0 || num <= 0) return 0;
  const size_t smem = (size_t)num * HIST_BINS * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_histogram_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  segment_histogram_kernel<<<blocks, HIST_THREADS, smem, stream>>>(
      depth, ids, lo, inv_w, n, num, out);
  return (int)cudaGetLastError();
}
