// Flash-attention prefill for Hopper: causal softmax attention of the
// language model's prompt pass with a per-row left pad, grouped-query
// K/V read in place.
//
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / rep] * scale)
//                        * v[b, j, h / rep]      over pad[b] <= j <= i
//
// for real query rows i >= pad[b]; rows i < pad[b] are written as zeros.
// Scores, the running softmax and the output accumulate in f32; the
// probabilities are rounded to the input type before the second product,
// as the plain version rounds them.
//
// Replaces leafgrasp_tpu/vla/llava_jax.py _flash_prefill (:284), the
// Pallas TPU flash attention with causal=True and segment ids, which pads
// the sequence to a block multiple, repeats K and V to the query head
// count and hands (512, 512) tiles to a sequential grid.
//
// Bound: operations. A launch at the serving shape (5 rows of 2400
// tokens, 32 heads of 128) does 4 * b * heads * hd * t(t+1)/2 = 2.4e11
// operations on 0.2 GB of inputs and outputs: about 1200 operations a
// byte, four times above the line where the tensor cores and not the
// memory are the limit. Only wgmma reaches the tensor cores' full rate,
// and beside the two products every score costs an exponential on the
// special-function unit (16 a cycle an SM: half the time the products
// take at 128 x 128 tiles), so the exponentials have to run under the
// products, not between them.
//
// bf16 design (flash_prefill_kernel). One persistent block an SM, three
// warpgroups. Each of the two consumer warpgroups owns 64 query rows of a
// 128-row tile of one head; the third warpgroup gives its registers away
// (setmaxnreg) and one of its threads is the producer: it brings the Q
// tile and the 128-key K and V tiles in by TMA (cp.async.bulk.tensor on
// rank-4 tensor maps of q and of the K/V cache as it lies: the head is
// h / rep, the strides are the caller's, nothing is repeated, copied or
// padded on the host) into a ring of two K and two V stages, each with a
// "full" and an "empty" mbarrier, so a K/V tile in shared memory serves
// 128 query rows and no consumer thread spends an instruction on a load.
// The token dimension of the maps is t, not the cache's length: TMA
// zero-fills the ragged last tile and never reads a row beyond t. A tile
// lies in shared memory as one or two 64-column halves of 128-byte rows
// in the 128-byte swizzle that the wgmma descriptors name. S = Q K^T is
// wgmma m64n128k16 with Q and K from shared memory, both as they lie
// (K-major); O += P V takes P from registers (the S accumulator of a
// warpgroup is laid out as the A operand) and V as it lies, which is
// MN-major for this product: the transpose bit of the instruction is
// set, V is not transposed in memory. A block walks work items (a query
// tile of one head of one row), heaviest first, strided over the grid,
// so the producer loads the next item's tiles while the consumers finish
// this one. Within an item it walks the key tiles from the pad's tile up
// to the diagonal, skewed by one tile: S(n) and O += P(n-1) V(n-1) are
// issued together and the softmax of tile n starts as soon as S(n) has
// landed, while the tensor cores still multiply (waiting for each
// product before the softmax took a tenth longer at the serving shape).
// The masked
// half of the square and the pad prefix are never visited, interior
// tiles skip the mask, the exponentials are
// ex2.approx (exp2f without its denormal branch; bf16 has f32's
// exponent range, a denormal probability is below every ulp) with
// log2(e) folded into the score scale, row maxima and sums are kept per
// thread quad, a row with no key yet keeps -inf and subtracts 0 so that
// nothing forms inf - inf, and pad rows are written as exact zeros.
// Resources (nvcc 12.8, -Xptxas -v): 168 registers at entry, 240 a
// consumer thread and 24 a producer thread after setmaxnreg, no spills;
// 161 KB of dynamic shared memory at head size 128 (81 KB at 64): one
// block an SM. What is left on the table: both warpgroups start an item
// together, so its first softmax and its last product find the tensor
// cores idle, and the group that owns the upper 64 rows multiplies the
// masked half of the diagonal tile.
//
// f32 design (flash_prefill_f32_kernel). Both products run on the tensor
// cores in bf16 with f32 sums, the f32 operands written as bf16 planes
// and the plane products summed smallest first, as the backward does
// (the note at the head of flash_prefill_bwd.cu; the helpers are in
// hopper.cuh): S = Q K^T takes three planes of each (six products; its
// error enters exp(S - m) absolutely), O += P V two planes of P, split
// in registers, and three of V (five products: p1 v1, p0 v2, p1 v0,
// p0 v1, p0 v0). A row whose probabilities are one-hot returns a V row,
// which two planes would leave up to 2^-17 of the value off: past the
// 2e-5 limit for |v| above 2.6 (tests/test_torch_flash_split.py
// emulates every product and the running softmax on the CPU). V is read
// as it lies, MN-major with the transpose bit, which wgmma offers for
// 16-bit types only: hence bf16 planes and not TF32. A block is one
// warpgroup that owns 64 query rows of one head, heaviest tiles first,
// and walks 32-key tiles from the pad's tile to the diagonal. TMA lands
// the f32 rows of Q (once) and of a K and a V tile (a ring of three
// stages) in dense rows inside the region of their planes; a thread pass
// splits them in place (split_tile). The walk is skewed: P(n) V(n) and
// S(n+1) are issued together, tile n+2 is split while they run, and the
// softmax of n+1 follows their wait. Masking, the running softmax
// (ex2.approx, maxima in raw units, the row's no-key case) and the
// epilogue are the bf16 kernel's. Bound: bytes at the training shape
// (2 rows of 642 tokens, 32 query heads over 8 K/V heads of 128): 53 MB
// of f32 inputs and outputs, 0.016 ms at 3.35 TB/s, against 6.8 GFLOP
// of the formulas' products; the split issues 11 bf16 products for the
// formulas' 2, 37 GFLOP, 0.038 ms at 989 TFLOP/s. Resources at head size
// 128: 198 KB of shared memory (Q 48 KB, three stages of 48 KB), one
// block an SM.
//
// Both instantiations can also write the row log-sum-exp of the scaled
// scores, lse[b, h, i] (natural log, f32; -inf on pad rows), which the
// backward (flash_prefill_bwd.cu) recomputes the probabilities from. It is
// converted once in the epilogue from the same maxima and sums that
// normalise the output. Both kernels take it as a template flag, so an
// instantiation without it carries no code for it.
//
// This file is built with fused multiply-adds allowed (the other kernels
// are not); there is no --use_fast_math.

#include <cuda.h>              // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Strides {                // in elements: batch, token, head
  long long b, t, h;
};

using namespace hopper;
using bf16 = __nv_bfloat16;

// natural-log log-sum-exp of a row from its maximum m2 (log2 units) and
// the sum l of exp2(score - m2); -inf for a pad row or a row with no key
__device__ __forceinline__ float lse_of(float m2, float l, bool real) {
  return (real && l > 0.0f) ? (m2 + log2f(l)) * 0.6931471805599453f
                            : -INFINITY;
}

// ============================ bf16: wgmma and TMA =============================

constexpr int WG_BM = 128;                    // query rows a work item
constexpr int WG_BN = 128;                    // keys a tile
constexpr int WG_ROWS = 64;                   // query rows a warpgroup
constexpr int WG_STAGES = 2;
constexpr int WG_CONSUMERS = 2;               // consumer warpgroups
constexpr int WG_THREADS = (WG_CONSUMERS + 1) * 128;
constexpr int HALF_BYTES = 128 * 128;         // 128 rows of 64 bf16
constexpr int ATOM_BYTES = 8 * 128;           // eight rows: a swizzle atom
constexpr uint32_t EMPTY_ARRIVALS = WG_CONSUMERS * 4;   // a lane of each warp

template <int HD> struct WgLayout {
  static constexpr int NH = HD / 64;                      // halves a tile
  static constexpr int TILE = NH * HALF_BYTES;
  static constexpr int Q = 0;
  static constexpr int K = TILE;
  static constexpr int V = TILE * (1 + WG_STAGES);
  static constexpr int BARS = TILE * (1 + 2 * WG_STAGES);
  // barriers: q_full, q_empty, then k_full, k_empty, v_full, v_empty a stage
  static constexpr int NBARS = 2 + 4 * WG_STAGES;
  static constexpr int BYTES = BARS + NBARS * 8 + 1024;   // + alignment
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// issues S = Q K^T of a warpgroup: 64 rows x 128 keys, both operands from
// shared memory as they lie (K-major); a k-step is 32 bytes along a row
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t q_desc,
                                         uint32_t k_addr) {
  const uint64_t k_desc = smem_desc(k_addr, 16, ATOM_BYTES);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
    wgmma_ss_n128(sc, q_desc + (off >> 4), k_desc + (off >> 4), kk > 0);
  }
}

// issues O += P V: P from registers, V as it lies (MN-major: the column
// halves are HALF_BYTES apart, a k-step is 16 rows of 128 bytes)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pr)[32],
                                         uint32_t v_addr) {
  const uint64_t v_desc = smem_desc(v_addr, HALF_BYTES, ATOM_BYTES);
#pragma unroll
  for (int kk = 0; kk < WG_BN / 16; ++kk) {
    const uint32_t a[4] = {pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2],
                           pr[4 * kk + 3]};
    const uint64_t desc = v_desc + ((kk * 16 * 128) >> 4);
    if constexpr (HD == 128) wgmma_rs_n128(o, a, desc, 1);
    else wgmma_rs_n64(o, a, desc, 1);
  }
}

// running softmax of a thread's two rows (row_a = its quad's row, row_b
// eight below); maxima in raw score units, sums this thread's share
struct RowState {
  float m_a, m_b, l_a, l_b;
};

// One key tile of the running softmax, in place: sc holds raw scores of
// N / 2 keys laid out as the wgmma accumulator (sc[4n + e]: columns
// 8n + 2tq + (e & 1), row_a for e < 2, row_b else) and leaves with the
// probabilities in f32.
// al_a, al_b: the factors that bring the earlier sums and outputs to the
// new maxima.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], RowState& st,
                                             float& al_a, float& al_b,
                                             bool masked, int k0, int p,
                                             int t, int row_a, int row_b,
                                             int tq, float scale2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = k0 + (i >> 2) * 8 + 2 * tq + (i & 1);
      const int row = (i & 2) ? row_b : row_a;
      if (!((j >= p) && (j <= row) && (j < t))) sc[i] = -INFINITY;
    }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(st.m_a, mx_a), mn_b = fmaxf(st.m_b, mx_b);
  // a row with no key yet keeps -inf; subtract 0 then, so that every
  // exponent is exp2(-inf) = 0 and never inf - inf
  const float mu_a = (mn_a == -INFINITY) ? 0.0f : mn_a;
  const float mu_b = (mn_b == -INFINITY) ? 0.0f : mn_b;
  al_a = exp2_approx((st.m_a - mu_a) * scale2);
  al_b = exp2_approx((st.m_b - mu_b) * scale2);
  st.m_a = mn_a;
  st.m_b = mn_b;
  const float ms_a = mu_a * scale2, ms_b = mu_b * scale2;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {              // a masked key gives exactly 0
    sc[4 * n] = exp2_approx(fmaf(sc[4 * n], scale2, -ms_a));
    sc[4 * n + 1] = exp2_approx(fmaf(sc[4 * n + 1], scale2, -ms_a));
    sc[4 * n + 2] = exp2_approx(fmaf(sc[4 * n + 2], scale2, -ms_b));
    sc[4 * n + 3] = exp2_approx(fmaf(sc[4 * n + 3], scale2, -ms_b));
    sum_a += sc[4 * n] + sc[4 * n + 1];
    sum_b += sc[4 * n + 2] + sc[4 * n + 3];
  }
  st.l_a = st.l_a * al_a + sum_a;
  st.l_b = st.l_b * al_b + sum_b;
}

// the probabilities rounded to bf16, as the A fragments of the second
// product: four registers for each 16 keys
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pr)[32]) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    pr[2 * n] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
    pr[2 * n + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float al_a,
                                        float al_b) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    o[4 * n] *= al_a;
    o[4 * n + 1] *= al_a;
    o[4 * n + 2] *= al_b;
    o[4 * n + 3] *= al_b;
  }
}

// a work item: query tile mt of head h of batch row b; items are ordered
// heaviest (last query tile) first, the heads of a K/V group side by side
struct Work {
  int b, h, q0, p, row_hi;
  bool empty;                                 // pad rows only
};
__device__ __forceinline__ Work decode_work(int idx, int n_mt, int b_n,
                                            int heads, int t,
                                            const int* __restrict__ pad) {
  Work w;
  const int per = b_n * heads;
  const int mt = n_mt - 1 - idx / per;
  const int rem = idx % per;
  w.b = rem / heads;
  w.h = rem % heads;
  w.q0 = mt * WG_BM;
  w.p = min(max(pad[w.b], 0), t);
  w.row_hi = min(w.q0 + WG_BM, t);
  w.empty = w.row_hi <= w.p;
  return w;
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const int* __restrict__ pad, bf16* __restrict__ out,
                     float* __restrict__ lse, int b_n, int t, int heads,
                     int rep, Strides os, float scale2, int n_mt,
                     int n_work) {
  using L = WgLayout<HD>;
  constexpr int NO = HD / 2;                  // output accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BARS;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 16 + 32 * s; };
  auto k_empty = [&](int s) { return bars + 24 + 32 * s; };
  auto v_full = [&](int s) { return bars + 32 + 32 * s; };
  auto v_empty = [&](int s) { return bars + 40 + 32 * s; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, EMPTY_ARRIVALS);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), EMPTY_ARRIVALS);
      mbar_init(v_empty(s), EMPTY_ARRIVALS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == WG_CONSUMERS) {
    // ======================= producer: one thread issues TMA loads
    reg_dealloc<24>();
    if (threadIdx.x == WG_CONSUMERS * 128) {
      int it = 0, items = 0;                  // tiles, work items so far
      for (int idx = blockIdx.x; idx < n_work; idx += gridDim.x) {
        const Work w = decode_work(idx, n_mt, b_n, heads, t, pad);
        if (w.empty) continue;
        const int kvh = w.h / rep;
        mbar_wait(q_empty, (items & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, L::TILE);
#pragma unroll
        for (int c = 0; c < L::NH; ++c)
          tma_load_4d(base + L::Q + c * HALF_BYTES, &map_q, q_full, c * 64,
                      w.q0, w.h, w.b);
        const int kt_first = w.p / WG_BN, kt_last = (w.row_hi - 1) / WG_BN;
        for (int kt = kt_first; kt <= kt_last; ++kt, ++it) {
          const int s = it % WG_STAGES;
          const uint32_t ph = ((it / WG_STAGES) & 1) ^ 1;
          mbar_wait(k_empty(s), ph);
          mbar_arrive_expect_tx(k_full(s), L::TILE);
#pragma unroll
          for (int c = 0; c < L::NH; ++c)
            tma_load_4d(base + L::K + s * L::TILE + c * HALF_BYTES, &map_k,
                        k_full(s), c * 64, kt * WG_BN, kvh, w.b);
          mbar_wait(v_empty(s), ph);
          mbar_arrive_expect_tx(v_full(s), L::TILE);
#pragma unroll
          for (int c = 0; c < L::NH; ++c)
            tma_load_4d(base + L::V + s * L::TILE + c * HALF_BYTES, &map_v,
                        v_full(s), c * 64, kt * WG_BN, kvh, w.b);
        }
        ++items;
      }
    }
  } else {
    // ======================= consumers: 64 query rows a warpgroup
    reg_alloc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int lr = wg * WG_ROWS + warp * 16 + g;          // rows lr, lr + 8
    const uint64_t q_desc =
        smem_desc(base + L::Q + wg * WG_ROWS * 128, 16, ATOM_BYTES);

    int it = 0, items = 0;
    for (int idx = blockIdx.x; idx < n_work; idx += gridDim.x) {
      const Work w = decode_work(idx, n_mt, b_n, heads, t, pad);
      bf16* ob = out + w.b * os.b + w.h * os.h;
      float* lb = LSE ? lse + ((long long)w.b * heads + w.h) * t : nullptr;
      if (w.empty) {                          // pad rows only: zeros
        const int ctid = threadIdx.x;         // 0 .. 255
        for (int i = ctid; i < (w.row_hi - w.q0) * (HD / 8);
             i += WG_CONSUMERS * 128) {
          const int r = i / (HD / 8), c = i % (HD / 8);
          *reinterpret_cast<uint4*>(ob + (long long)(w.q0 + r) * os.t
                                    + 8 * c) = make_uint4(0, 0, 0, 0);
        }
        if constexpr (LSE)
          for (int r = w.q0 + ctid; r < w.row_hi; r += WG_CONSUMERS * 128)
            lb[r] = -INFINITY;
        continue;
      }
      const int p = w.p;
      const int row_a = w.q0 + lr, row_b = row_a + 8;
      const int wg_first = w.q0 + wg * WG_ROWS;           // rows of the group
      const int kt_first = p / WG_BN, kt_last = (w.row_hi - 1) / WG_BN;

      float o[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = 0.0f;
      RowState st{-INFINITY, -INFINITY, 0.0f, 0.0f};
      float sc[64];                           // scores, then probabilities
      uint32_t pr[32];                        // P in bf16: the A fragments
      float al_a, al_b;
      // A tile behind the pad, under the group's first row and inside the
      // sequence has no masked key.
      auto masked = [&](int k0) {
        return (k0 < p) || (k0 + WG_BN - 1 > wg_first) || (k0 + WG_BN > t);
      };
      auto release_k = [&](int s, bool last) {
        if (lane == 0) {
          mbar_arrive(k_empty(s));
          if (last) mbar_arrive(q_empty);     // Q is read no more
        }
      };

      // The walk is skewed by one tile, so that the exponentials of tile
      // n run while the tensor cores multiply P(n-1) V(n-1): S(n) and
      // then O += P(n-1) V(n-1) are issued together, the softmax starts
      // when S(n) alone has landed, and O is rescaled once the second
      // product has landed too.
      mbar_wait(q_full, items & 1);
      {                                       // the first tile's scores
        const int s = it % WG_STAGES;
        mbar_wait(k_full(s), (it / WG_STAGES) & 1);
        wgmma_fence();
        issue_qk<HD>(sc, q_desc, base + L::K + s * L::TILE);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        release_k(s, kt_first == kt_last);
        const int k0 = kt_first * WG_BN;
        softmax_tile(sc, st, al_a, al_b, masked(k0), k0, p, t, row_a, row_b,
                     tq, scale2);             // o is zero: nothing to rescale
        pack_p(sc, pr);
      }
      for (int kt = kt_first + 1; kt <= kt_last; ++kt) {
        const int sv = it % WG_STAGES;        // V of the tile before
        const uint32_t phv = (it / WG_STAGES) & 1;
        ++it;
        const int s = it % WG_STAGES;
        mbar_wait(k_full(s), (it / WG_STAGES) & 1);
        reg_fence(o);
        wgmma_fence();
        issue_qk<HD>(sc, q_desc, base + L::K + s * L::TILE);
        wgmma_commit();
        mbar_wait(v_full(sv), phv);
        wgmma_fence();                        // P's registers feed this one
        issue_pv<HD>(o, pr, base + L::V + sv * L::TILE);
        wgmma_commit();
        wgmma_wait<1>();                      // the scores have landed
        reg_fence(sc);
        release_k(s, kt == kt_last);
        const int k0 = kt * WG_BN;
        softmax_tile(sc, st, al_a, al_b, masked(k0), k0, p, t, row_a, row_b,
                     tq, scale2);
        wgmma_wait<0>();                      // O += P V has landed
        reg_fence(o);
        if (lane == 0) mbar_arrive(v_empty(sv));
        rescale(o, al_a, al_b);
        pack_p(sc, pr);
      }
      {                                       // the last tile's P V
        const int sv = it % WG_STAGES;
        mbar_wait(v_full(sv), (it / WG_STAGES) & 1);
        reg_fence(o);
        wgmma_fence();
        issue_pv<HD>(o, pr, base + L::V + sv * L::TILE);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(o);
        if (lane == 0) mbar_arrive(v_empty(sv));
        ++it;
      }
      float l_a = st.l_a, l_b = st.l_b;
      ++items;

      // ---- epilogue: finish the row sums over the quad, normalise, store
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float inv_a = (row_a >= p && l_a > 0.0f) ? 1.0f / l_a : 0.0f;
      const float inv_b = (row_b >= p && l_b > 0.0f) ? 1.0f / l_b : 0.0f;
      if constexpr (LSE) {                    // maxima in raw score units
        if (tq == 0) {
          if (row_a < t) lb[row_a] = lse_of(st.m_a * scale2, l_a, row_a >= p);
          if (row_b < t) lb[row_b] = lse_of(st.m_b * scale2, l_b, row_b >= p);
        }
      }
#pragma unroll
      for (int n = 0; n < NO / 4; ++n) {
        const int col = n * 8 + 2 * tq;
        if (row_a < t)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + (long long)row_a * os.t + col) =
              __floats2bfloat162_rn(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
        if (row_b < t)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + (long long)row_b * os.t + col) =
              __floats2bfloat162_rn(o[4 * n + 2] * inv_b,
                                    o[4 * n + 3] * inv_b);
      }
    }
  }
}

// rank-4 map of a (batch, token, head, hd) bf16 tensor read as boxes of
// `rows` tokens x 64 columns of one head in the 128-byte swizzle; `tokens`
// bounds the token dimension, so rows beyond it are zero-filled
bool make_map(CUtensorMap* map, const void* ptr, int hd, int tokens,
              int n_heads, int b, Strides s, int rows) {
  return make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16),
                     ptr, hd, tokens, n_heads, b, s.b, s.t, s.h, 64, rows,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD, bool LSE>
int launch_bf16(const void* q, const void* k, const void* v, const int* pad,
                void* out, float* lse, int b, int t, int heads, int kv_heads,
                Strides qs, Strides ks, Strides vs, Strides os, float scale,
                cudaStream_t stream) {
  using L = WgLayout<HD>;
  static int sm_count = 0;
  auto kernel = flash_prefill_kernel<HD, LSE>;
  if (sm_count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) {
      sm_count = 0;
      return (int)err;
    }
  }
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, HD, t, heads, b, qs, WG_BM)
      || !make_map(&mk, k, HD, t, kv_heads, b, ks, WG_BN)
      || !make_map(&mv, v, HD, t, kv_heads, b, vs, WG_BN))
    return (int)cudaErrorInvalidValue;
  const int n_mt = (t + WG_BM - 1) / WG_BM;
  const long long n_work = (long long)n_mt * b * heads;
  if (n_work > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_work < sm_count ? n_work : sm_count);
  kernel<<<grid, WG_THREADS, L::BYTES, stream>>>(
      mq, mk, mv, pad, static_cast<bf16*>(out), lse, b, t, heads,
      heads / kv_heads, os, scale * 1.4426950408889634f, n_mt, (int)n_work);
  return (int)cudaGetLastError();
}

// ========================= f32: wgmma on bf16 planes ==========================

constexpr int F_BN = 32;                      // keys a stream tile
constexpr int F_NST = 3;                      // stages of the K/V ring
constexpr int F_SP = 3;                       // planes of Q and of K (S)
constexpr int F_VP = 3;                       // planes of V (P takes two)

// shared-memory layout, in bytes from a 1024-byte boundary: Q's planes,
// then the stages (K's planes, then V's), then the barriers (q_full, then
// a full barrier a stage)
template <int HD> struct F32Layout {
  static constexpr int NH = HD / 64;                      // column halves
  static constexpr int QPLANE = NH * PLANE_M * 128;
  static constexpr int SPLANE = NH * F_BN * 128;
  static constexpr int Q = 0;
  static constexpr int STREAM = F_SP * QPLANE;
  static constexpr int V = F_SP * SPLANE;                 // in a stage
  static constexpr int STAGE = (F_SP + F_VP) * SPLANE;
  static constexpr int BARS = STREAM + F_NST * STAGE;
  static constexpr int BYTES = BARS + (1 + F_NST) * 8 + 1024;
  // bytes that land for Q, and for a stage (a K and a V tile)
  static constexpr int Q_TX = PLANE_M * HD * 4;
  static constexpr int STAGE_TX = 2 * F_BN * HD * 4;
};

template <int HD, bool LSE>
__global__ void __launch_bounds__(PLANE_THREADS, 1)
flash_prefill_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const int* __restrict__ pad, float* __restrict__ out,
                         float* __restrict__ lse, int b_n, int t, int heads,
                         int rep, Strides os, float scale2, int n_mt) {
  using L = F32Layout<HD>;
  constexpr int BN = F_BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw_u32);
  const uint32_t q_full = base + L::BARS;
  auto full = [&](int s) { return q_full + 8 + 8 * s; };
  auto stage = [&](int s) { return base + L::STREAM + s * L::STAGE; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // the block's query tile, batch row and head: the last query tiles (the
  // longest walks) first, the heads of a K/V group side by side
  const int per = b_n * heads;
  const int q0 = (n_mt - 1 - (int)blockIdx.x / per) * PLANE_M;
  const int bi = (int)blockIdx.x % per / heads;
  const int h = (int)blockIdx.x % heads;
  const int p = min(max(pad[bi], 0), t);
  const int row_hi = min(q0 + PLANE_M, t);
  float* ob = out + bi * os.b + h * os.h;
  float* lb = LSE ? lse + ((long long)bi * heads + h) * t : nullptr;
  if (row_hi <= p) {                          // pad rows only: zeros
    for (int i = tid; i < (row_hi - q0) * (HD / 4); i += PLANE_THREADS) {
      const int r = i / (HD / 4), c = i % (HD / 4);
      *reinterpret_cast<float4*>(ob + (long long)(q0 + r) * os.t + 4 * c) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if constexpr (LSE)
      for (int r = q0 + tid; r < row_hi; r += PLANE_THREADS) lb[r] = -INFINITY;
    return;
  }
  // the walk: key tiles kt0 .. up to the tile's last row, of K/V head kvh
  const int kt0 = p / BN;
  const int n_steps = (row_hi - 1) / BN - kt0 + 1;
  const int kvh = h / rep;
  auto load_stage = [&](int n) {              // thread 0 only
    const int s = n % F_NST, row0 = (kt0 + n) * BN;
    mbar_arrive_expect_tx(full(s), L::STAGE_TX);
    tma_load_4d(stage(s), &map_k, full(s), 0, row0, kvh, bi);
    tma_load_4d(stage(s) + L::V, &map_v, full(s), 0, row0, kvh, bi);
  };
  auto split_stage = [&](int n) {             // every thread
    const int s = n % F_NST;
    mbar_wait(full(s), (n / F_NST) & 1);
    split_tile<BN, HD, F_SP>(sbase + L::STREAM + s * L::STAGE);
    split_tile<BN, HD, F_VP>(sbase + L::STREAM + s * L::STAGE + L::V);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < F_NST; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(q_full, L::Q_TX);
    tma_load_4d(base + L::Q, &map_q, q_full, 0, q0, h, bi);
    for (int n = 0; n < F_NST && n < n_steps; ++n) load_stage(n);
  }
  mbar_wait(q_full, 0);
  split_tile<PLANE_M, HD, F_SP>(sbase + L::Q);
  split_stage(0);
  __syncthreads();                            // the planes are published

  // this thread's rows: ra and ra + 8
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  RowState st{-INFINITY, -INFINITY, 0.0f, 0.0f};
  float x[BN / 2];                            // scores, then probabilities
  uint32_t p0[BN / 4], p1[BN / 4];            // P in two bf16 planes
  float al_a, al_b;
  auto scores = [&](int n) {
    issue_planes<HD, BN, F_SP>(x, base + L::Q, stage(n % F_NST), L::QPLANE,
                               L::SPLANE);
  };
  // the probabilities of tile n from its scores, split for P V. A tile
  // behind the pad, under the block's first row and inside the sequence
  // has no masked key.
  auto probs = [&](int n) {
    const int c0 = (kt0 + n) * BN;
    const bool masked = c0 < p || c0 + BN - 1 > q0 || c0 + BN > t;
    softmax_tile(x, st, al_a, al_b, masked, c0, p, t, ra, rb, tq, scale2);
    split_frag<BN / 2>(x, p0, p1);
  };

  wgmma_fence();
  scores(0);
  wgmma_commit();
  if (n_steps > 1) split_stage(1);            // meanwhile
  wgmma_wait<0>();
  reg_fence(x);
  probs(0);                                   // o is zero: nothing to rescale
  __syncthreads();                            // stage 1's planes: published
  for (int n = 0; n < n_steps; ++n) {
    // O += P(n) V(n) and S(n+1) together; tile n+2 is split meanwhile
    reg_fence(o);
    wgmma_fence();
    issue_second<HD, BN, F_VP>(o, p0, p1, stage(n % F_NST) + L::V,
                               L::SPLANE);
    if (n + 1 < n_steps) scores(n + 1);
    wgmma_commit();
    if (n + 2 < n_steps) split_stage(n + 2);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(x);
    reg_fence(p0);
    reg_fence(p1);
    __syncthreads();                          // stage n is read by all, and
                                              // stage n+2's planes published
    if (tid == 0 && n + F_NST < n_steps) {
      fence_proxy_async();
      load_stage(n + F_NST);
    }
    if (n + 1 < n_steps) {
      probs(n + 1);
      rescale(o, al_a, al_b);
    }
  }

  // ---- epilogue: finish the row sums over the quad, normalise, store
  float l_a = st.l_a, l_b = st.l_b;
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = (ra >= p && l_a > 0.0f) ? 1.0f / l_a : 0.0f;
  const float inv_b = (rb >= p && l_b > 0.0f) ? 1.0f / l_b : 0.0f;
  if constexpr (LSE) {                        // maxima in raw score units
    if (tq == 0) {
      if (ra < t) lb[ra] = lse_of(st.m_a * scale2, l_a, ra >= p);
      if (rb < t) lb[rb] = lse_of(st.m_b * scale2, l_b, rb >= p);
    }
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * tq;
    if (ra < t)
      *reinterpret_cast<float2*>(ob + (long long)ra * os.t + col) =
          make_float2(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
    if (rb < t)
      *reinterpret_cast<float2*>(ob + (long long)rb * os.t + col) =
          make_float2(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
  }
}

template <int HD, bool LSE>
int launch_f32(const void* q, const void* k, const void* v, const int* pad,
               void* out, float* lse, int b, int t, int heads, int kv_heads,
               Strides qs, Strides ks, Strides vs, Strides os, float scale,
               cudaStream_t stream) {
  using L = F32Layout<HD>;
  static bool ready = false;
  auto kernel = flash_prefill_f32_kernel<HD, LSE>;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  // f32 rows as they lie, whole (no swizzle): the split pass reads them
  auto map = [&](CUtensorMap* m, const void* ptr, int n_heads, Strides s,
                 int rows) {
    return make_map_4d(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, HD, t,
                       n_heads, b, s.b, s.t, s.h, HD, rows,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  CUtensorMap mq, mk, mv;
  if (!map(&mq, q, heads, qs, PLANE_M) || !map(&mk, k, kv_heads, ks, F_BN)
      || !map(&mv, v, kv_heads, vs, F_BN))
    return (int)cudaErrorInvalidValue;
  const int n_mt = (t + PLANE_M - 1) / PLANE_M;
  const long long blocks = (long long)n_mt * b * heads;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(int)blocks, PLANE_THREADS, L::BYTES, stream>>>(
      mq, mk, mv, pad, static_cast<float*>(out), lse, b, t, heads,
      heads / kv_heads, os, scale * 1.4426950408889634f, n_mt);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (b, t, heads, hd); k, v: (b, >= t, kv_heads, hd), only the first
// t rows are read. strides: twelve element strides, (batch, token, head)
// of q, k, v, out; the last dimension is contiguous and every row starts
// on a 16-byte boundary. is_bf16: 1 for bf16 in and out, 0 for f32. hd is
// 64 or 128 (the sizes instantiated). lse: null, or (b, heads, t) f32
// contiguous for the row log-sum-exp.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const int* pad, void* out, int b, int t,
                             int heads, int kv_heads, int hd, int is_bf16,
                             const long long* strides, float scale,
                             float* lse, cudaStream_t stream) {
  if (b <= 0 || t <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  if (is_bf16) {
    if (lse != nullptr) {
      if (hd == 64)
        return launch_bf16<64, true>(q, k, v, pad, out, lse, b, t, heads,
                                     kv_heads, qs, ks, vs, os, scale, stream);
      return launch_bf16<128, true>(q, k, v, pad, out, lse, b, t, heads,
                                    kv_heads, qs, ks, vs, os, scale, stream);
    }
    if (hd == 64)
      return launch_bf16<64, false>(q, k, v, pad, out, nullptr, b, t, heads,
                                    kv_heads, qs, ks, vs, os, scale, stream);
    return launch_bf16<128, false>(q, k, v, pad, out, nullptr, b, t, heads,
                                   kv_heads, qs, ks, vs, os, scale, stream);
  }
  if (lse != nullptr) {
    if (hd == 64)
      return launch_f32<64, true>(q, k, v, pad, out, lse, b, t, heads,
                                  kv_heads, qs, ks, vs, os, scale, stream);
    return launch_f32<128, true>(q, k, v, pad, out, lse, b, t, heads,
                                 kv_heads, qs, ks, vs, os, scale, stream);
  }
  if (hd == 64)
    return launch_f32<64, false>(q, k, v, pad, out, nullptr, b, t, heads,
                                 kv_heads, qs, ks, vs, os, scale, stream);
  return launch_f32<128, false>(q, k, v, pad, out, nullptr, b, t, heads,
                                kv_heads, qs, ks, vs, os, scale, stream);
}
