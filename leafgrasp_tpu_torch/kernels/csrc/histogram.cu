// Per-segment 256-bin histograms for Hopper, for R brackets at once:
//   out[r, id, bin] += 1 for every pixel with 0 <= id < num, where
//   bin = (int)clip((depth - lo[r, id]) * inv_w[r, id], 0, 255)
//
// Replaces leafgrasp_tpu/ops/pallas_median.py segment_histogram /
// _hist_kernel (:76 / :31). R = 1 is that kernel's call; R = 2 is two of
// its calls on the same pixels, as the two-level median makes them for
// its two order statistics (ops/median.py), in one read of the frame.
//
// Bound: bytes. A pixel is 8 bytes read (f32 depth, int32 id) and a few
// operations; the (R, num, 256) counts are a few KB. 1080 x 1440 is
// 12.44 MB, 3.7 us at 3.35 TB/s. The first version of this kernel took
// 8.5 us: it loaded an id, branched on it, then loaded the depth and
// gathered the bracket, two device-memory latencies in a row for every
// pixel, and matched the keys of a warp's lanes on every pixel.
//
// Design. The TPU kernel counts with one-hot matrix products because the
// TPU has no scatter; here every block keeps (R, num, 256) int32 counts in
// shared memory and adds with shared-memory atomics.
// - No dependent loads. A thread takes groups of HIST_PPT = 8 consecutive
//   pixels, loads each group's depth and ids as two 16-byte vectors each,
//   without a condition, and loads the next group before it counts this
//   one (registers as a double buffer: 64 bytes a thread in flight). The
//   first group is loaded before the block zeroes its counts and stages
//   the brackets (R * num (lo, inv_w) pairs, once a block, not a gather a
//   pixel), so its latency hides that set-up. The eight keys of a group
//   are computed before any of them is counted, so their shared-memory
//   reads and arithmetic overlap; the brackets live in their own array,
//   so the compiler knows that an atomic add to a count leaves them.
// - Runs, not pixels. A thread's groups are consecutive (a block takes
//   one contiguous slab of the frame, a thread a contiguous piece of it),
//   and neighbouring pixels mostly share a leaf and a bin, so the thread
//   keeps (key, count) of the run it is in for each bracket in registers
//   and adds to shared memory only when the key changes and at its end.
// - One large block an SM. The fixed cost of a block, zeroing and
//   scanning its R * num * 256 counts and adding each non-zero one into
//   the output with a global atomic, is paid once an SM (a block of 1024
//   threads an SM, 32 warps for the loads; the wrapper sizes the grid to
//   the card's SMs); the slabs are equal, so no SM waits on another's
//   second block. The flush adds four counts at
//   a time (a 16-byte atomic add, Hopper's), since a refined level's
//   counts lie dense.
// - The output is f32 and zeroed by cudaMemsetAsync in the entry point:
//   no zeros kernel and no cast kernel around the launch. The counts are
//   integers and the wrapper keeps n <= 2^24, so every partial sum is an
//   exact f32 and the order of the atomic adds does not matter.
// - Alignment: the vectors start at the first 16-byte-aligned pixel of
//   depth; ids must be aligned alike (the wrapper copies one that is
//   not, the entry point checks). The head before it and the ragged tail
//   (fewer than 4 and 8 pixels) are counted by scalar loads in the last
//   block.
// With parts switched off on the card, the loads with the set-up and an
// empty flush take most of the time and stay above the bound; counting
// adds a share for each bracket, the global flush the rest, most at a
// refined level. PERF.md has the times.

// The bin is a separate subtract and multiply in f32 (the build passes
// -fmad=false), clipped before the cast, as the plain version computes
// it: a fused multiply-add or a cast before the clip would move pixels
// on a bin edge to the next bin.

#include <cuda_runtime.h>
#include <stdint.h>

#define HIST_BINS 256
#define HIST_THREADS 1024   // one block an SM: 64 registers a thread
#define HIST_PPT 8          // pixels of a group: two 16-byte vectors
#define HIST_MAX_CELLS 222  // R * num: the counts within 227 KB

struct Group {
  float4 d0, d1;
  int4 i0, i1;
};

__device__ __forceinline__ Group load_group(const float4* d4, const int4* i4,
                                            int g) {
  Group v;
  v.d0 = __ldg(d4 + 2 * g);
  v.d1 = __ldg(d4 + 2 * g + 1);
  v.i0 = __ldg(i4 + 2 * g);
  v.i1 = __ldg(i4 + 2 * g + 1);
  return v;
}

// The bin's key in the (R, num, HIST_BINS) counts, or -1 for an id out of
// range; br holds (lo, inv_w) of each (bracket, segment).
template <int R>
__device__ __forceinline__ void keys(const float2* br, int num, float d,
                                     int id, int (&k)[R]) {
  const bool ok = (unsigned)id < (unsigned)num;
  const int idc = ok ? id : 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 b = br[r * num + idc];
    float x = (d - b.x) * b.y;
    x = fminf(fmaxf(x, 0.0f), (float)(HIST_BINS - 1));
    k[r] = ok ? (r * num + idc) * HIST_BINS + (int)x : -1;
  }
}

// A thread's run of equal keys, one for each bracket: added to the shared
// counts when the key changes and at the end.
template <int R>
struct Runs {
  int key[R], cnt[R];

  __device__ __forceinline__ Runs() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      key[r] = -1;
      cnt[r] = 0;
    }
  }

  __device__ __forceinline__ void add(int* hist, const int (&k)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (k[r] != key[r]) {
        if (key[r] >= 0) atomicAdd(&hist[key[r]], cnt[r]);
        key[r] = k[r];
        cnt[r] = 0;
      }
      ++cnt[r];
    }
  }

  // the eight keys of a group first (independent loads and arithmetic),
  // then the runs
  __device__ __forceinline__ void add_group(int* hist, const float2* br,
                                            int num, const Group& v) {
    const float d[HIST_PPT] = {v.d0.x, v.d0.y, v.d0.z, v.d0.w,
                               v.d1.x, v.d1.y, v.d1.z, v.d1.w};
    const int id[HIST_PPT] = {v.i0.x, v.i0.y, v.i0.z, v.i0.w,
                              v.i1.x, v.i1.y, v.i1.z, v.i1.w};
    int k[HIST_PPT][R];
#pragma unroll
    for (int j = 0; j < HIST_PPT; ++j) keys<R>(br, num, d[j], id[j], k[j]);
#pragma unroll
    for (int j = 0; j < HIST_PPT; ++j) add(hist, k[j]);
  }

  __device__ __forceinline__ void flush(int* hist) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (key[r] >= 0) atomicAdd(&hist[key[r]], cnt[r]);
  }
};

// n pixels: ``head`` scalar ones, then ``groups`` groups of HIST_PPT from
// the aligned ``depth + head`` / ``ids + head``, then the tail. Block b
// takes the b-th of gridDim.x equal slabs of the groups, each thread a
// contiguous piece of its slab.
template <int R>
__global__ void __launch_bounds__(HIST_THREADS)
segment_histogram_kernel(const float* __restrict__ depth,
                         const int* __restrict__ ids,
                         const float* __restrict__ lo,
                         const float* __restrict__ inv_w, int n, int num,
                         int head, int groups, float* __restrict__ out) {
  extern __shared__ __align__(16) int hist[];   // (R, num, HIST_BINS)
  // the brackets apart from the counts, so that the compiler knows an
  // atomic add to a count leaves them as they were
  __shared__ float2 s_br[HIST_MAX_CELLS];
  const int cells = R * num * HIST_BINS;        // a multiple of 4

  const float4* d4 = reinterpret_cast<const float4*>(depth + head);
  const int4* i4 = reinterpret_cast<const int4*>(ids + head);
  const int s0 = (int)((long long)blockIdx.x * groups / gridDim.x);
  const int s1 = (int)((long long)(blockIdx.x + 1) * groups / gridDim.x);
  const int per = (s1 - s0 + HIST_THREADS - 1) / HIST_THREADS;
  const int g0 = s0 + threadIdx.x * per;
  const int g1 = min(g0 + per, s1);

  Group cur;
  if (g0 < g1) cur = load_group(d4, i4, g0);   // in flight during set-up

  int4* h4 = reinterpret_cast<int4*>(hist);
  for (int i = threadIdx.x; i < cells / 4; i += HIST_THREADS)
    h4[i] = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < R * num; i += HIST_THREADS)
    s_br[i] = make_float2(lo[i], inv_w[i]);
  __syncthreads();

  Runs<R> runs;
  for (int g = g0; g < g1; ++g) {
    Group nxt;
    if (g + 1 < g1) nxt = load_group(d4, i4, g + 1);
    runs.add_group(hist, s_br, num, cur);
    cur = nxt;
  }
  runs.flush(hist);

  if (blockIdx.x == gridDim.x - 1) {    // the scalar head and tail, by
    const int t = threadIdx.x;         // threads 0-3 and 32-39
    const int tail0 = head + groups * HIST_PPT;
    const int p = t < head ? t
                : (t >= 32 && t - 32 < n - tail0) ? tail0 + t - 32 : -1;
    if (p >= 0) {
      int k[R];
      keys<R>(s_br, num, depth[p], ids[p], k);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (k[r] >= 0) atomicAdd(&hist[k[r]], 1);
    }
  }
  __syncthreads();

  float4* o4 = reinterpret_cast<float4*>(out);
  for (int i = threadIdx.x; i < cells / 4; i += HIST_THREADS) {
    const int4 v = h4[i];
    if (v.x | v.y | v.z | v.w)
      atomicAdd(o4 + i, make_float4((float)v.x, (float)v.y, (float)v.z,
                                    (float)v.w));
  }
}

template <int R>
static int launch(const float* depth, const int* ids, const float* lo,
                  const float* inv_w, int n, int num, int blocks, float* out,
                  cudaStream_t stream) {
  const int head = (int)((16 - ((uintptr_t)depth & 15)) & 15) / 4;
  const int h = n < head ? n : head;
  const int groups = (n - h) / HIST_PPT;
  const size_t smem = (size_t)R * num * HIST_BINS * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_histogram_kernel<R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  segment_histogram_kernel<R><<<blocks, HIST_THREADS, smem, stream>>>(
      depth, ids, lo, inv_w, n, num, h, groups, out);
  return (int)cudaGetLastError();
}

// depth f32 and ids int32, n pixels each, at the same offset from a
// 16-byte boundary; lo, inv_w (R, num) f32; out (R, num, HIST_BINS) f32,
// zeroed here; blocks: the grid, at most one block for every
// HIST_THREADS groups of HIST_PPT pixels (the wrapper sizes it). n <= 2^24
// keeps the f32 counts exact.
extern "C" int segment_histogram(const float* depth, const int* ids,
                                 const float* lo, const float* inv_w, int n,
                                 int num, int r, int blocks, float* out,
                                 cudaStream_t stream) {
  if (num <= 0 || (r != 1 && r != 2) || r * num > HIST_MAX_CELLS
      || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)depth ^ (uintptr_t)ids) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)r * num * HIST_BINS * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (r == 1)
    return launch<1>(depth, ids, lo, inv_w, n, num, blocks, out, stream);
  return launch<2>(depth, ids, lo, inv_w, n, num, blocks, out, stream);
}
