// Row-banded EDT pass 2 for Hopper:
//   out[c, i, j] = min over i' of g2r[c, i', j] + (i - i')^2
// where each RB_ROWS x RB_COLS output tile visits only the candidate
// rows within its own radius nb of the tile.
//
// Replaces leafgrasp_tpu/ops/pallas_edt.py squared_edt_rowband /
// _rowband_kernel (:215 / :175), radii included (:243-255).
//
// Bound: operations. Each (output, candidate row) pair inside a tile's
// band costs an add and a min (2 counted operations), against 8 bytes per
// pixel of traffic. An SM issues one warp instruction a cycle in each of
// its four partitions, so a pair that costs a fused multiply-add and a
// min takes at least two cycles a warp: 85.3 M pairs at (1, 540, 720)
// over 132 SMs x 128 lanes at 1.98 GHz is 5.1 us.
//
// Two launches a call.
//
// 1. rowband_radius_kernel: a cluster of RB_CLUSTER blocks a 32-column
//    quarter of a 128-column stripe (four times the clusters a whole
//    stripe would give, so that the step spreads over the card). Each
//    block min-pools its share of the quarter's row tiles into its shared
//    memory and sets their outputs to +inf for the sweep's atomic minima;
//    after a cluster barrier every block gathers the whole quarter's
//    pooled rows from its peers' shared memory (distributed shared
//    memory, RB_GATHER loads a thread in flight) and solves, a warp a row
//    tile, the min-plus at 1/RB_ROWS row resolution with the offset
//    (RB_ROWS (|I - I'| + 1))^2, which bounds every output of row tile I
//    from above; the quarter asks for floor(sqrt(max)) + 1, at most H,
//    and the tile's radius nb is the largest of its four quarters'. Any
//    pointwise upper bound keeps the result exact: the winning row i* has
//    (i - i*)^2 <= out <= bound <= nb^2. The pooled rows never leave the
//    chip; the last cluster barrier is split so that a block waits for
//    its peers only before it exits.
// 2. rowband_kernel: the sweep, split by band length, not by tile. Two
//    row tiles make a row group of RB_OUT output rows whose band is the
//    union of theirs; a group's band is cut into items of RB_CH
//    candidate rows, and a persistent grid of 128-thread blocks (a thread
//    a column) takes the items round-robin, so the time follows the total
//    work and not the tile farthest from a seed. Each block builds its
//    groups' bands and item offsets from the radii in its shared memory
//    (a block scan; RB_SEG groups at a time) and finds an item's group by
//    binary search: no host read, no list in device memory; block 0
//    writes the tiles' radii out. A thread loads its column's RB_CH
//    candidate values at once (all loads in flight before the
//    arithmetic), then takes each (output row k, candidate row i) pair as
//      acc[k] = fminf(acc[k], fmaf(d, d, v[i])),  d = D + (k - i),
//    one multiply-add and one min: the RB_CH + RB_OUT - 1 distinct
//    offsets d are computed once an item, and a candidate load feeds
//    RB_OUT pairs. The partial minima of a group's items meet in `out` by
//    atomicMin on the bits: the values are non-negative floats or +inf,
//    whose bit patterns order as unsigned integers, so the merge is exact
//    and independent of order. (Tried on an H100 and left out, PERF.md:
//    8, 24 or 32 output rows an item, 16 or 24 candidate rows, loading
//    the next item ahead, an even split of band rows over the blocks,
//    and the DPX add-min __viaddmin_s32 on integer values, all slower.)
//
// All inputs are integer-valued f32 (non-negative, or +inf); fmaf rounds
// v + d^2 once, as the plain version rounds g2r + d * d (d * d is exact),
// so the result is bit-identical to it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#define RB_ROWS 8        // output rows of a tile (the radii's row tile)
#define RB_COLS 128      // output columns of a tile, threads of a sweep block
#define RB_QC 32         // columns of a radius block: a quarter tile
#define RB_CLUSTER 8     // blocks of a quarter stripe in the radius step
#define RB_RY 8          // thread rows of a radius block: 32 x 8 threads
#define RB_OUT 16        // output rows of a sweep item (a multiple of RB_ROWS)
#define RB_CH 32         // candidate rows of a sweep item
#define RB_SEG 2048      // row groups a sweep block indexes at a time
#define RB_GATHER 16     // remote loads a radius thread keeps in flight
#define RB_SMEM_MAX (227 * 1024)

// dynamic shared memory of a radius block: its own pooled rows and the
// whole quarter stripe's, gathered
static inline size_t rb_radius_smem(int RT, int RPB) {
  return (size_t)(RPB + RT) * RB_QC * sizeof(float);
}

// nb4[c, I, ct, q]: the radius that quarter q (32 columns) of tile (I, ct)
// asks for; the tile's radius is the largest of the four
__global__ void __cluster_dims__(RB_CLUSTER, 1, 1)
__launch_bounds__(RB_QC * RB_RY)
rowband_radius_kernel(const float* __restrict__ g2r, int H, int W, int RT,
                      int CT, int RPB, int* __restrict__ nb4,
                      float* __restrict__ out) {
  extern __shared__ float smem[];
  float* pool = smem;                         // [RPB][RB_QC], this block's
  float* stripe = smem + RPB * RB_QC;         // [RT][RB_QC], gathered
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int qs = blockIdx.y;                  // quarter stripe: ct * 4 + q
  const int c = blockIdx.z;
  const int x = threadIdx.x, y = threadIdx.y;
  const int tid = y * RB_QC + x;
  const int j = qs * RB_QC + x;
  const bool j_ok = j < W;
  const int I0 = rank * RPB;
  const float* src = g2r + (size_t)c * H * W + j;
  float* dst = out + (size_t)c * H * W + j;

  for (int t = y; t < RPB; t += RB_RY) {
    const int I = I0 + t;
    const int r0 = I * RB_ROWS;
    float m = INFINITY;
    if (I < RT && j_ok) {
      float v[RB_ROWS];
#pragma unroll
      for (int r = 0; r < RB_ROWS; ++r)
        v[r] = r0 + r < H ? src[(size_t)(r0 + r) * W] : INFINITY;
#pragma unroll
      for (int r = 0; r < RB_ROWS; ++r) {
        m = fminf(m, v[r]);
        if (r0 + r < H) dst[(size_t)(r0 + r) * W] = INFINITY;
      }
    }
    pool[t * RB_QC + x] = m;
  }
  cluster.sync();
  // the quarter stripe's pooled rows from every block of the cluster, up to
  // RB_GATHER remote loads a thread in flight
  constexpr int NT = RB_QC * RB_RY;
  for (int e0 = tid; e0 < RT * RB_QC; e0 += RB_GATHER * NT) {
    float v[RB_GATHER];
#pragma unroll
    for (int q = 0; q < RB_GATHER; ++q) {
      const int k = (e0 + q * NT) / RB_QC;
      v[q] = k < RT
          ? cluster.map_shared_rank(pool, k / RPB)[(k % RPB) * RB_QC + x]
          : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < RB_GATHER; ++q)
      if (e0 + q * NT < RT * RB_QC) stripe[e0 + q * NT] = v[q];
  }
  // this block is done reading its peers; it waits for them to be done
  // with it only before it exits
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  for (int t = y; t < RPB; t += RB_RY) {      // a warp a tile
    const int I = I0 + t;
    if (I >= RT) break;
    float u = 0.0f;                           // columns past W bound nothing
    if (j_ok) {
      // k = I, I - 1, ..., 0 and I + 1, ..., RT - 1, with the offset
      // d = RB_ROWS (|I - k| + 1) carried; fmaf rounds u + d^2 once, as
      // the plain version's g2c + d^2 (d^2 is exact)
      u = INFINITY;
      float d = (float)RB_ROWS;
#pragma unroll 4
      for (int k = I; k >= 0; --k, d += (float)RB_ROWS)
        u = fminf(u, __fmaf_rn(d, d, stripe[k * RB_QC + x]));
      d = (float)(2 * RB_ROWS);
#pragma unroll 4
      for (int k = I + 1; k < RT; ++k, d += (float)RB_ROWS)
        u = fminf(u, __fmaf_rn(d, d, stripe[k * RB_QC + x]));
    }
    for (int off = 16; off > 0; off >>= 1)
      u = fmaxf(u, __shfl_xor_sync(0xffffffffu, u, off));
    if (x == 0)
      // floor(sqrt(u)) + 1 clamped to H, as the plain version takes it in
      // float64 (a root at or above H clamps, +inf included)
      nb4[((size_t)c * RT + I) * CT * 4 + qs] =
          (double)u >= (double)H * H ? H : (int)sqrt((double)u) + 1;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(RB_COLS)
rowband_kernel(const float* __restrict__ g2r, int C, int H, int W, int RT,
               int CT, const int* __restrict__ nb4, int* __restrict__ nb,
               float* __restrict__ out) {
  constexpr int OUT = RB_OUT, CH = RB_CH, GT = OUT / RB_ROWS;
  __shared__ int start[RB_SEG];       // first item of each group
  __shared__ int2 band[RB_SEG];       // candidate rows [lo, hi] of a group
  __shared__ int wsum[RB_COLS / 32];
  const int x = threadIdx.x, lane = x & 31, warp = x >> 5;
  const int RG = (RT + GT - 1) / GT;
  const int ngroups = C * RG * CT;
  long long carry = 0;                // items of the segments before
  for (int seg0 = 0; seg0 < ngroups; seg0 += RB_SEG) {
    const int nseg = min(RB_SEG, ngroups - seg0);
    // each group's band, the union of its tiles', with every load in flight;
    // block 0 writes the tiles' radii out
    for (int t0 = 0; t0 < nseg; t0 += 4 * RB_COLS) {
      int4 r4[4][GT];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = t0 + q * RB_COLS + x;
        const int g = seg0 + t;
        const int c = g / (RG * CT), G = (g / CT) % RG, ct = g % CT;
#pragma unroll
        for (int m = 0; m < GT; ++m) {
          const int I = G * GT + m;
          r4[q][m] = t < nseg && I < RT
              ? reinterpret_cast<const int4*>(nb4)[((size_t)c * RT + I) * CT + ct]
              : make_int4(-1, -1, -1, -1);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = t0 + q * RB_COLS + x;
        if (t >= nseg) continue;
        const int g = seg0 + t;
        const int c = g / (RG * CT), G = (g / CT) % RG, ct = g % CT;
        int lo = H, hi = 0;
#pragma unroll
        for (int m = 0; m < GT; ++m) {
          const int I = G * GT + m;
          const int4 v = r4[q][m];
          const int r = max(max(v.x, v.y), max(v.z, v.w));
          if (r < 0) continue;                // past the last row tile
          lo = min(lo, max(I * RB_ROWS - r, 0));
          hi = max(hi, min(I * RB_ROWS + RB_ROWS - 1 + r, H - 1));
          if (blockIdx.x == 0) nb[((size_t)c * RT + I) * CT + ct] = r;
        }
        band[t] = make_int2(lo, hi);
        start[t] = (hi - lo + CH) / CH;
      }
    }
    __syncthreads();
    // exclusive scan in place: a run of groups a thread, then the block
    const int per = (nseg + RB_COLS - 1) / RB_COLS;
    const int a = min(x * per, nseg), b = min(a + per, nseg);
    int run = 0;
    for (int t = a; t < b; ++t) run += start[t];
    int incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int pos = incl - run, total = 0;
    for (int w = 0; w < RB_COLS / 32; ++w) {
      if (w < warp) pos += wsum[w];
      total += wsum[w];
    }
    for (int t = a; t < b; ++t) {
      const int n = start[t];
      start[t] = pos;
      pos += n;
    }
    __syncthreads();

    // item g of the segment (CH candidate rows of one group) is global
    // item carry + g; this block takes those congruent to its index
    long long g0 = ((long long)blockIdx.x - carry) % gridDim.x;
    if (g0 < 0) g0 += gridDim.x;
    for (int g = (int)g0; g < total; g += gridDim.x) {
      int t = 0, hi_t = nseg - 1;     // the last group starting at or before g
      while (t < hi_t) {
        const int mid = (t + hi_t + 1) >> 1;
        if (start[mid] <= g) t = mid; else hi_t = mid - 1;
      }
      const int2 bd = band[t];
      const int rs = bd.x + (g - start[t]) * CH;
      const int n = min(CH, bd.y + 1 - rs);
      const int grp = seg0 + t;
      const int ct = grp % CT;
      const int G = (grp / CT) % RG;
      const int c = grp / (CT * RG);
      const int row0 = G * OUT;
      const int j = ct * RB_COLS + x;
      const float* col = g2r + ((size_t)c * H + rs) * W + j;
      float v[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        v[i] = i < n && j < W ? __ldg(col + (size_t)i * W) : INFINITY;
      const float D = (float)(row0 - rs);
      float acc[OUT];
#pragma unroll
      for (int k = 0; k < OUT; ++k) acc[k] = INFINITY;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
#pragma unroll
        for (int k = 0; k < OUT; ++k) {
          const float d = D + (float)(k - i);   // row0 + k - (rs + i)
          acc[k] = fminf(acc[k], __fmaf_rn(d, d, v[i]));
        }
      }
      if (j < W) {
        unsigned int* o = reinterpret_cast<unsigned int*>(
            out + ((size_t)c * H + row0) * W + j);
#pragma unroll
        for (int k = 0; k < OUT; ++k)
          if (row0 + k < H)
            atomicMin(o + (size_t)k * W, __float_as_uint(acc[k]));
      }
    }
    carry += total;
    __syncthreads();                  // start[] and band[] are rewritten
  }
}

static int sweep_grid() {
  static int grid[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, rowband_kernel, RB_COLS, 0)
            != cudaSuccess)
      return 0;
    grid[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return grid[dev];
}

static int rb_radius(const float* g2r, int C, int H, int W, int* nb4,
                     float* out, cudaStream_t stream) {
  const int RT = (H + RB_ROWS - 1) / RB_ROWS;
  const int CT = (W + RB_COLS - 1) / RB_COLS;
  const int RPB = (RT + RB_CLUSTER - 1) / RB_CLUSTER;
  const size_t smem = rb_radius_smem(RT, RPB);
  if (smem > RB_SMEM_MAX || CT * 4 > 65535 || C > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rowband_radius_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rowband_radius_kernel<<<dim3(RB_CLUSTER, CT * 4, C), dim3(RB_QC, RB_RY),
                          smem, stream>>>(g2r, H, W, RT, CT, RPB, nb4, out);
  return (int)cudaGetLastError();
}

static int rb_sweep(const float* g2r, int C, int H, int W, const int* nb4,
                    int* nb, float* out, cudaStream_t stream) {
  const int RT = (H + RB_ROWS - 1) / RB_ROWS;
  const int CT = (W + RB_COLS - 1) / RB_COLS;
  const int grid = sweep_grid();
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  rowband_kernel<<<grid, RB_COLS, 0, stream>>>(
      g2r, C, H, W, RT, CT, nb4, nb, out);
  return (int)cudaGetLastError();
}

// nb4: (C, RT, CT, 4) int32 scratch; nb: (C, RT, CT) int32 and out
// (C, H, W) f32, written here.
extern "C" int squared_edt_rowband(const float* g2r, int C, int H, int W,
                                   int* nb4, int* nb, float* out,
                                   cudaStream_t stream) {
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  const int err = rb_radius(g2r, C, H, W, nb4, out, stream);
  if (err != 0) return err;
  return rb_sweep(g2r, C, H, W, nb4, nb, out, stream);
}
