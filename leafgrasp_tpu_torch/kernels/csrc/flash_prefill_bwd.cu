// Backward of the flash-attention prefill for Hopper: the gradients of
//
//   out[b, i, h] = sum_j P[b, h, i, j] v[b, j, h / rep],
//   P = softmax_j(q[b, i, h] . k[b, j, h / rep] * scale) over pad[b] <= j <= i
//
// given the forward's output O, its row log-sum-exp (natural log; -inf on
// pad rows) and the output's gradient dO. With D_i = sum_d dO[i, d] O[i, d]
// and P recomputed as exp(S scale - lse), FlashAttention-2's formulas:
//
//   dV = P^T dO,   dP = dO V^T,   dS = P o (dP - D),
//   dK = scale dS^T Q,   dQ = scale dS K
//
// The gradients come out in f32 from f32 sums, for f32 and bf16 inputs.
// Only the keys pad[b] <= j <= i count; pad rows, pad keys and rows at or
// beyond t give exact zeros, never inf - inf (a masked probability is set
// to 0, not computed). Every output element has one owner that sums in a
// fixed order, with no atomics: two runs give the same bits.
//
// Replaces the two backward Pallas kernels of the TPU flash attention that
// leafgrasp_tpu/vla/llava_jax.py _flash_prefill (:314) differentiates
// through: _flash_attention_bwd_dq (jax/experimental/pallas/ops/tpu/
// flash_attention.py:1287, pallas_call at :1456) and
// _flash_attention_bwd_dkv (:941, pallas_call at :1121). Their block
// structure is not carried over: there the grid is sequential and K/V are
// repeated to the query heads first.
//
// Bound: operations, on the tensor cores. Per visible (query, key) pair
// and query head dQ takes three products of 2 hd operations (S, dP, dS K)
// and dK/dV four (S, dP, P^T dO, dS^T Q); with the split below the kernels
// issue 12 and 15 bf16 products for f32 inputs and 4 and 6 for bf16. At
// the training shape (2 rows of 642 tokens, 32 query heads over 8 K/V
// heads of 128) in f32 that is 41 and 51 GFLOP, 0.041 and 0.051 ms at
// 989 TFLOP/s, on 95 and 63 MB of inputs and outputs (0.028 and 0.019 ms
// at 3.35 TB/s).
//
// The split. wgmma multiplies bf16 (or TF32, about 11 bits) with f32 sums;
// the gradients must stay within 1e-5 of their norm of the plain f32
// version. So an f32 operand is written as bf16 planes, x = x0 + x1 (+ x2),
// x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1): two planes keep
// 16 significant bits, three 24. A product of two planed operands sums the
// plane products whose order is below the kept precision, smallest first:
// a1 b0 + a0 b1 + a0 b0 for two planes (the dropped a1 b1 is 2^-16 of a
// term), and a1 b1 + a2 b0 + a0 b2 + a1 b0 + a0 b1 + a0 b0 for three.
// S = Q K^T takes three planes: its error enters exp(S scale - lse) as an
// absolute error of the exponent, which grows with |S|; with q and k at 8
// times unit scale (|S scale| in the tens) two planes gave 4e-5 of the
// norm and three give the f32 floor, 3e-6 (tests/test_torch_flash_split.py
// emulates the arithmetic). dP and the three products with P or dS as the
// register operand take two planes (their errors are relative, 2^-16).
// bf16 inputs are exact in one plane: S and dP are one product each, and
// only P and dS, which are f32, are split (P0 X + P1 X). They are not
// rounded to bf16 as the TPU kernel rounds them. Bf16 planes, not TF32,
// because wgmma transposes an operand from shared memory only for 16-bit
// types: with bf16 the tiles that are MN-major for a product (dO and Q for
// dV and dK, K for dQ) are read as they lie, through the descriptor's
// transpose bit, and never copied. The helpers that split tiles and
// fragments and issue the plane products live in hopper.cuh, which the
// f32 forward (flash_prefill.cu) shares.
//
// Structure. One body serves both kernels. A block is one warpgroup (128
// threads) that owns a fixed tile of 64 rows, F1 and F2, and walks a
// stream of tiles of BN rows, S1 and S2:
//
//   dQ   (flash_prefill_bwd_dq_kernel): F = (Q, dO) of 64 query rows of
//        one head, S = (K, V) key tiles from the pad's tile to the diagonal;
//        X = F1 S1^T = S, Y = F2 S2^T = dP, dQ += dS S1.
//   dK/dV (flash_prefill_bwd_dkv_kernel): F = (K, V) of 64 keys of one K/V
//        head, S = (Q, dO) query tiles from the keys' diagonal to t, for
//        each the query heads of the group in turn; X = S^T, Y = dP^T,
//        dV += P^T S2, dK += dS^T S1.
//
// X and Y are wgmma with both operands from shared memory, K-major as the
// tiles lie; the second products take P or dS from registers (the
// accumulator layout of X is the A-fragment layout) and S1 or S2 as they
// lie, MN-major, with the transpose bit. A tile lies in shared memory as
// one or two 64-column halves of 128-byte rows in the 128-byte swizzle.
// Thread 0 brings the tiles in by TMA (rank-4 tensor maps of the tensors
// as they lie; the token dimension is t, so rows beyond it arrive as
// zeros): the fixed tiles once, the stream into a ring of two stages, each
// behind an mbarrier, two tiles ahead. bf16 tiles land swizzled, as the
// products read them. f32 tiles land as dense rows and a thread pass
// splits them in place into their planes (the region of a tile holds its
// planes, which take as many or more bytes than the f32 rows). The pass
// over tile n+1 runs while the tensor cores multiply X and Y of tile n.
// Between the products, P = exp2(S scale log2(e) - lse log2(e)) on the
// special-function unit (ex2.approx, 2^-22 of the value), masked only on
// the tiles at the pad, the diagonal or t; dK/dV issues dV += P^T S2
// before it forms dS, so that the tensor cores run while it does. The D
// of a query row is the dQ kernel's prologue (from dO and O), which
// writes it out for the dK/dV kernel; the dK/dV kernel reads the rows'
// log-sum-exp and D for each stream tile with plain loads.
//
// f32 uses 32-row stream tiles (BN) and bf16 64: the f32 planes of a
// 64-row fixed tile and two stages take 160 KB at head size 128 (one block
// an SM), bf16 96 KB (two). Blocks are ordered heaviest first: the last
// query tiles (dQ) and the first key tiles (dK/dV), which walk the most
// stream tiles; the hardware hands each freed SM the next block. The
// first key tile walks rep * t / BN stream tiles; where that is longer
// than a block slot's share of the whole (few key tiles, as at the
// training shape), a cluster of 2 or 4 blocks shares the key tile, each
// with its part of the query heads, and sums the parts through
// distributed shared memory in rank order: no scratch, no atomics.
//
// Resources (nvcc 12.8, -Xptxas -v, no spills): dQ 208 registers for f32
// at head size 128, 126 at 64, 154 and 122 for bf16; dK/dV 245 and 166
// for f32, 250 and 187 for bf16.
//
// What is left on the table: one warpgroup a block waits for its products
// between the dependent steps (S -> P, dS -> dQ), with nothing of its own
// to overlap (the registers hold no second X, Y); X and Y read both
// operands from shared memory, 3 KB for 16 cycles of products at BN 32;
// each block loads and splits its fixed tiles before its first product.

#include <cuda.h>              // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;
using bf16 = __nv_bfloat16;

struct Strides {                // in elements: batch, token, head
  long long b, t, h;
};

constexpr int FR = 64;          // rows of the fixed tile (wgmma's M)
constexpr int NTHREADS = 128;   // one warpgroup
constexpr int NST = 2;          // stages of the stream ring

// shared-memory layout, in bytes from a 1024-byte boundary
template <typename T, int HD> struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int BN = F32 ? 32 : 64;      // rows of a stream tile
  static constexpr int P1 = F32 ? 3 : 1;        // planes of F1, S1 (S)
  static constexpr int P2 = F32 ? 2 : 1;        // planes of F2, S2 (dP)
  static constexpr int NH = HD / 64;            // 64-column halves
  static constexpr int FHALF = FR * 128;
  static constexpr int SHALF = BN * 128;
  static constexpr int FPLANE = NH * FHALF;
  static constexpr int SPLANE = NH * SHALF;
  static constexpr int F1 = 0;
  static constexpr int F2 = P1 * FPLANE;
  static constexpr int STREAM = (P1 + P2) * FPLANE;
  static constexpr int S2 = P1 * SPLANE;        // S1 at 0 in a stage
  static constexpr int STAGE = (P1 + P2) * SPLANE;
  static constexpr int ROWS = STREAM + NST * STAGE;    // lse, D: floats
  static constexpr int BARS = ROWS + NST * 2 * 64 * 4;
  static constexpr int BYTES = BARS + (1 + NST) * 8 + 1024;
  // bytes that land for the two fixed tiles, and for a stage
  static constexpr int FIXED_TX = 2 * FR * HD * (int)sizeof(T);
  static constexpr int STAGE_TX = 2 * BN * HD * (int)sizeof(T);
};

// 16 bytes of a row, widened to f32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }
};
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const bf16* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// rows ra and ra + 8 of a (rows, HD) f32 output, times `mul`, rows < t
template <int HD>
__device__ __forceinline__ void store_rows(float* dst, long long row_stride,
                                           const float (&acc)[HD / 2],
                                           int ra, int t, int tq, float mul) {
  const int rb = ra + 8;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * tq;
    if (ra < t)
      *reinterpret_cast<float2*>(dst + (long long)ra * row_stride + col) =
          make_float2(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (rb < t)
      *reinterpret_cast<float2*>(dst + (long long)rb * row_stride + col) =
          make_float2(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// what the probabilities of a step need: the stream tile's rows (dK/dV:
// lse log2(e) at rs[c]), its first row c0, this thread's fixed rows ra
// and rb with (dQ) their lse log2(e), the pad, t, and the score scale
// times log2(e)
struct Rows {
  const float* rs;
  int c0, ra, rb;
  float l2_a, l2_b;
  int p, t, tq;
  float scale2;
};

// P = exp2(S scale log2(e) - lse log2(e)) in place of the scores x, in the
// accumulator layout: x[4m + e] is fixed row ra (e < 2) or rb and stream
// row c0 + 8m + 2tq + (e & 1). With MASK a key that the query does not see
// gets exactly 0 (selected, so that an exponent of a pad row's -inf never
// reaches the product).
template <bool MASK, bool DKV, int BN>
__device__ __forceinline__ void probs(float (&x)[BN / 2], const Rows& w) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int c = 8 * (i >> 2) + 2 * w.tq + (i & 1);
    const int fr = (i & 2) ? w.rb : w.ra;
    const float l2 = DKV ? w.rs[c] : ((i & 2) ? w.l2_b : w.l2_a);
    float pr = exp2_approx(fmaf(x[i], w.scale2, -l2));
    if (MASK) {
      const int q = DKV ? w.c0 + c : fr, k = DKV ? fr : w.c0 + c;
      pr = (k >= w.p && k <= q && q < w.t) ? pr : 0.0f;
    }
    x[i] = pr;
  }
}

struct Args {
  const void* o;                // dQ: O and dO, for D
  const void* dout;
  Strides os, dos;
  const int* pad;
  const float* lse;             // (b, heads, t)
  float* dsum;                  // (b, heads, t): dQ writes D, dK/dV reads
  float* out1;                  // dQ, or dK
  float* out2;                  // dV
  Strides o1s, o2s;
  int b, t, heads, rep, n_tiles;
  int cs;                       // dK/dV: blocks (a cluster) a key tile
  float scale;
};

// the body of both kernels (see the note at the head of the file)
template <typename T, int HD, bool DKV>
__device__ __forceinline__ void flash_bwd(const CUtensorMap& map_f1,
                                          const CUtensorMap& map_f2,
                                          const CUtensorMap& map_s1,
                                          const CUtensorMap& map_s2,
                                          const Args& a) {
  using C = Cfg<T, HD>;
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw_u32);
  float* rows_s = reinterpret_cast<float*>(sbase + C::ROWS);
  const uint32_t fixed_full = base + C::BARS;
  auto full = [&](int s) { return base + C::BARS + 8 + 8 * s; };
  auto stage = [&](int s) { return base + C::STREAM + s * C::STAGE; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kv_heads = a.heads / a.rep;
  const int groups = DKV ? kv_heads : a.heads;  // heads of the fixed tile
  const int per = a.b * groups;
  // dK/dV: the cs blocks of a cluster share a key tile and take rep / cs
  // query heads each; rank 0 the first
  const int cs = DKV ? a.cs : 1;
  const int item = (int)blockIdx.x / cs, rank = (int)blockIdx.x % cs;
  const int tile = DKV ? item / per : a.n_tiles - 1 - item / per;
  const int bi = item % per / groups;
  const int hh = item % groups;
  const int t = a.t, rep = a.rep / cs;          // dK/dV: heads a block
  const int r0 = tile * FR;
  const int p = min(max(a.pad[bi], 0), t);
  const int r_hi = min(r0 + FR, t);

  // the stream: dQ walks key tiles kt0.. of K/V head hh / rep; dK/dV
  // walks (query tile, head) pairs from query tile kt0, heads in turn
  int kt0 = 0, n_steps = 0;
  if (DKV) {
    if (r0 + FR - 1 >= p) {                   // a key of the tile is real
      kt0 = max(r0, p) / BN;
      n_steps = ((t - 1) / BN - kt0 + 1) * rep;
    }
  } else if (r_hi > p) {                      // a row of the tile is real
    kt0 = p / BN;
    n_steps = (r_hi - 1) / BN - kt0 + 1;
  }
  auto step_row0 = [&](int n) { return (kt0 + (DKV ? n / rep : n)) * BN; };
  auto step_head = [&](int n) {
    return DKV ? (hh * cs + rank) * rep + n % rep : hh / a.rep;
  };

  auto load_stage = [&](int n) {              // thread 0 only
    const int s = n % NST;
    const int row0 = step_row0(n), head = step_head(n);
    const uint32_t st = stage(s);
    mbar_arrive_expect_tx(full(s), C::STAGE_TX);
    if constexpr (C::F32) {
      tma_load_4d(st, &map_s1, full(s), 0, row0, head, bi);
      tma_load_4d(st + C::S2, &map_s2, full(s), 0, row0, head, bi);
    } else {
#pragma unroll
      for (int c = 0; c < C::NH; ++c) {
        tma_load_4d(st + c * C::SHALF, &map_s1, full(s), c * 64, row0, head,
                    bi);
        tma_load_4d(st + C::S2 + c * C::SHALF, &map_s2, full(s), c * 64,
                    row0, head, bi);
      }
    }
  };
  // dK/dV: the log-sum-exp (times log2(e)) and D of a stream tile's
  // query rows
  auto load_rows = [&](int n) {
    const int s = n % NST;
    const int row0 = step_row0(n), head = step_head(n);
    const long long lrow = ((long long)bi * a.heads + head) * t;
    if (tid < 2 * BN) {
      const int c = tid % BN, i = row0 + c;
      const float* src = tid < BN ? a.lse : a.dsum;
      const float mul = tid < BN ? LOG2E : 1.0f;
      rows_s[s * 128 + tid] = i < t ? src[lrow + i] * mul : 0.0f;
    }
  };

  if (tid == 0) {
    mbar_init(fixed_full, 1);
    for (int s = 0; s < NST; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && n_steps > 0) {
    mbar_arrive_expect_tx(fixed_full, C::FIXED_TX);
    if constexpr (C::F32) {
      tma_load_4d(base + C::F1, &map_f1, fixed_full, 0, r0, hh, bi);
      tma_load_4d(base + C::F2, &map_f2, fixed_full, 0, r0, hh, bi);
    } else {
#pragma unroll
      for (int c = 0; c < C::NH; ++c) {
        tma_load_4d(base + C::F1 + c * C::FHALF, &map_f1, fixed_full, c * 64,
                    r0, hh, bi);
        tma_load_4d(base + C::F2 + c * C::FHALF, &map_f2, fixed_full, c * 64,
                    r0, hh, bi);
      }
    }
    for (int n = 0; n < NST && n < n_steps; ++n) load_stage(n);
  }

  // this thread's rows of the fixed tile: ra and ra + 8
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  float l2_a = 0.0f, l2_b = 0.0f, d_a = 0.0f, d_b = 0.0f;   // lse log2(e)
  const float scale2 = a.scale * LOG2E;
  if constexpr (!DKV) {
    // prologue: D = rowsum(dO o O) of the tile's rows, two threads a row
    // in a fixed order, written out for the dK/dV kernel
    const int rr = tid >> 1, half = tid & 1, row = r0 + rr;
    const long long lrow = ((long long)bi * a.heads + hh) * t;
    float acc = 0.0f;
    if (row < t) {
      const T* dop = static_cast<const T*>(a.dout) + bi * a.dos.b
                     + hh * a.dos.h + (long long)row * a.dos.t;
      const T* op = static_cast<const T*>(a.o) + bi * a.os.b + hh * a.os.h
                    + (long long)row * a.os.t;
      constexpr int V = Vec<T>::N;
#pragma unroll 4
      for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); c += V) {
        float x[V], y[V];
        Vec<T>::load(dop + c, x);
        Vec<T>::load(op + c, y);
#pragma unroll
        for (int e = 0; e < V; ++e) acc = fmaf(x[e], y[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      rows_s[rr] = row < t ? a.lse[lrow + row] : 0.0f;
      rows_s[FR + rr] = acc;
      if (row < t) a.dsum[lrow + row] = acc;
    }
    __syncthreads();
    l2_a = rows_s[ra - r0] * LOG2E;
    l2_b = rows_s[rb - r0] * LOG2E;
    d_a = rows_s[FR + ra - r0];
    d_b = rows_s[FR + rb - r0];
    __syncthreads();                          // rows_s is the stages' now
  }

  float acc1[HD / 2];                         // dQ, or dK
  float acc2[DKV ? HD / 2 : 1];               // dV
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc1[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (DKV ? HD / 2 : 1); ++i) acc2[i] = 0.0f;

  if (n_steps > 0) {
    mbar_wait(fixed_full, 0);
    if constexpr (C::F32) {
      split_tile<FR, HD, C::P1>(sbase + C::F1);
      split_tile<FR, HD, C::P2>(sbase + C::F2);
    }
    mbar_wait(full(0), 0);
    if constexpr (C::F32) {
      split_tile<BN, HD, C::P1>(sbase + C::STREAM);
      split_tile<BN, HD, C::P2>(sbase + C::STREAM + C::S2);
    }
    if constexpr (DKV) load_rows(0);
    __syncthreads();
  }

  for (int n = 0; n < n_steps; ++n) {
    const int s = n % NST;
    const uint32_t st = stage(s);
    const int c0 = step_row0(n);              // the stream tile's first row
    float x[BN / 2], y[BN / 2];
    wgmma_fence();
    issue_planes<HD, BN, C::P1>(x, base + C::F1, st, C::FPLANE, C::SPLANE);
    issue_planes<HD, BN, C::P2>(y, base + C::F2, st + C::S2, C::FPLANE,
                                C::SPLANE);
    wgmma_commit();
    reg_fence(x);
    reg_fence(y);
    if (n + 1 < n_steps) {                    // the next tile, meanwhile
      const int s1 = (n + 1) % NST;
      mbar_wait(full(s1), ((n + 1) / NST) & 1);
      if constexpr (C::F32) {
        split_tile<BN, HD, C::P1>(sbase + C::STREAM + s1 * C::STAGE);
        split_tile<BN, HD, C::P2>(sbase + C::STREAM + s1 * C::STAGE + C::S2);
      }
      if constexpr (DKV) load_rows(n + 1);
    }
    wgmma_wait<0>();
    reg_fence(x);
    reg_fence(y);

    // P into x, then dS into y; only a tile at the pad, the diagonal or
    // t is masked
    const float* rs = rows_s + s * 128;       // dK/dV: the columns' rows
    const bool edge = DKV ? (r0 < p || r0 + FR - 1 > c0 || c0 + BN > t)
                          : (c0 < p || c0 + BN - 1 > r0 || r0 + FR > t);
    const Rows rw{rs, c0, ra, rb, l2_a, l2_b, p, t, tq, scale2};
    if (edge) probs<true, DKV, BN>(x, rw);
    else probs<false, DKV, BN>(x, rw);
    if constexpr (DKV) {                      // dV += P^T S2 meanwhile
      uint32_t p0[BN / 4], p1[BN / 4];
      split_frag<BN / 2>(x, p0, p1);
      reg_fence(acc2);
      wgmma_fence();
      issue_second<HD, BN, C::P2>(acc2, p0, p1, st + C::S2, C::SPLANE);
      wgmma_commit();
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
      const float d = DKV ? rs[BN + c] : ((i & 2) ? d_b : d_a);
      y[i] = x[i] * (y[i] - d);
    }
    uint32_t ds0[BN / 4], ds1[BN / 4];
    split_frag<BN / 2>(y, ds0, ds1);
    reg_fence(acc1);
    wgmma_fence();
    issue_second<HD, BN, C::P2>(acc1, ds0, ds1, st, C::SPLANE);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc1);
    if constexpr (DKV) reg_fence(acc2);
    __syncthreads();                          // stage s is read by all
    if (tid == 0 && n + NST < n_steps) {
      fence_proxy_async();
      load_stage(n + NST);
    }
  }

  if constexpr (DKV) {
    float* dk = a.out1 + bi * a.o1s.b + hh * a.o1s.h;
    float* dv = a.out2 + bi * a.o2s.b + hh * a.o2s.h;
    if (cs == 1) {
      store_rows<HD>(dk, a.o1s.t, acc1, ra, t, tq, a.scale);
      store_rows<HD>(dv, a.o2s.t, acc2, ra, t, tq, 1.0f);
      return;
    }
    // the cluster's sum over its query heads: each block leaves its dK and
    // dV in the stream stages (free now), then rank q sums the column
    // groups m = q (mod cs) over the ranks in rank order, the same order
    // every run
    static_assert(NST * C::STAGE >= HD * 128 * 4, "partials fit");
    float* part = reinterpret_cast<float*>(sbase + C::STREAM);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      part[i * NTHREADS + tid] = acc1[i];
      part[(HD / 2 + i) * NTHREADS + tid] = acc2[i];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int m = rank; m < HD / 8; m += cs) {
      float sk[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int q = 0; q < cs; ++q) {
        const float* pq = cluster.map_shared_rank(part, q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sk[e] += pq[(4 * m + e) * NTHREADS + tid];
          sv[e] += pq[(HD / 2 + 4 * m + e) * NTHREADS + tid];
        }
      }
      const int col = 8 * m + 2 * tq;
      if (ra < t) {
        *reinterpret_cast<float2*>(dk + (long long)ra * a.o1s.t + col) =
            make_float2(sk[0] * a.scale, sk[1] * a.scale);
        *reinterpret_cast<float2*>(dv + (long long)ra * a.o2s.t + col) =
            make_float2(sv[0], sv[1]);
      }
      if (rb < t) {
        *reinterpret_cast<float2*>(dk + (long long)rb * a.o1s.t + col) =
            make_float2(sk[2] * a.scale, sk[3] * a.scale);
        *reinterpret_cast<float2*>(dv + (long long)rb * a.o2s.t + col) =
            make_float2(sv[2], sv[3]);
      }
    }
    cluster.sync();                           // no block leaves while read
  } else {
    store_rows<HD>(a.out1 + bi * a.o1s.b + hh * a.o1s.h, a.o1s.t, acc1, ra, t,
                   tq, a.scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_prefill_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_do,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const Args a) {
  flash_bwd<T, HD, false>(map_q, map_do, map_k, map_v, a);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_prefill_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_do,
                             const Args a) {
  flash_bwd<T, HD, true>(map_k, map_v, map_q, map_do, a);
}

// rank-4 map of a (batch, token, head, hd) input read as tiles of `rows`
// tokens: bf16 as 64-column boxes in the 128-byte swizzle that the
// products read, f32 as whole dense rows that the split pass reads
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, int hd, int t, int n_heads,
              int b, Strides s, int rows) {
  if (std::is_same<T, float>::value)
    return make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, hd, t,
                       n_heads, b, s.b, s.t, s.h, hd, rows,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  return make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, hd, t,
                     n_heads, b, s.b, s.t, s.h, 64, rows,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

constexpr int SMEM_PER_SM = 233472;          // 228 KB, of which a block 227

// dK/dV: the blocks that share a key tile, each taking rep / cs of its
// query heads. The first key tile walks the whole stream, rep * t / BN
// steps; where that is more than a block slot of the card gets on average
// (few key tiles: the training shape), the walk is cut into the fewest
// pieces (1, 2 or 4, dividing rep) that bring it down to the average, or
// as far as 4 do. A cut costs each extra block its fixed tiles and the
// sum of the partials.
int cluster_size(const Args& a, int bn, int slots) {
  const int n_bn = (a.t + bn - 1) / bn;
  long long total = 0;
  for (int kt = 0; kt < a.n_tiles; ++kt) total += n_bn - kt * FR / bn;
  total *= (long long)a.b * a.heads;          // rep heads a K/V head
  const double mean = (double)total / (slots > 0 ? slots : 1);
  const long long longest = (long long)n_bn * a.rep;
  int cs = 1;
  while (cs < 4 && a.rep % (2 * cs) == 0 && longest > cs * mean) cs *= 2;
  return cs;
}

// f1, f2: the fixed tiles' tensors (64 rows), s1, s2: the stream's (BN
// rows); fh: heads of the fixed tensors, sh: of the stream's
template <typename T, int HD, bool DKV>
int launch(const void* f1, Strides f1s, const void* f2, Strides f2s, int fh,
           const void* s1, Strides s1s, const void* s2, Strides s2s, int sh,
           Args& a, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  static int sm_count = 0;
  auto kernel = DKV ? flash_prefill_bwd_dkv_kernel<T, HD>
                    : flash_prefill_bwd_dq_kernel<T, HD>;
  if (sm_count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) {
      sm_count = 0;
      return (int)err;
    }
  }
  CUtensorMap m1, m2, m3, m4;
  if (!make_map<T>(&m1, f1, HD, a.t, fh, a.b, f1s, FR)
      || !make_map<T>(&m2, f2, HD, a.t, fh, a.b, f2s, FR)
      || !make_map<T>(&m3, s1, HD, a.t, sh, a.b, s1s, C::BN)
      || !make_map<T>(&m4, s2, HD, a.t, sh, a.b, s2s, C::BN))
    return (int)cudaErrorInvalidValue;
  a.n_tiles = (a.t + FR - 1) / FR;
  a.cs = DKV ? cluster_size(a, C::BN, sm_count * (SMEM_PER_SM / C::BYTES))
             : 1;
  const long long blocks = (long long)a.n_tiles * a.b * a.cs
                           * (DKV ? a.heads / a.rep : a.heads);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = C::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.cs;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, m1, m2, m3, m4,
                                             (const Args)a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

bool bad_shape(int b, int t, int heads, int kv_heads, int hd) {
  return b <= 0 || t <= 0 || heads <= 0 || kv_heads <= 0
         || heads % kv_heads != 0 || (hd != 64 && hd != 128);
}

void unpack(const long long* strides, Strides* s) {
  for (int i = 0; i < 6; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <bool DKV>
int dispatch(int is_bf16, int hd, const void* f1, Strides f1s,
             const void* f2, Strides f2s, int fh, const void* s1,
             Strides s1s, const void* s2, Strides s2s, int sh, Args& a,
             cudaStream_t stream) {
  if (is_bf16) {
    if (hd == 64)
      return launch<bf16, 64, DKV>(f1, f1s, f2, f2s, fh, s1, s1s, s2, s2s, sh,
                                   a, stream);
    return launch<bf16, 128, DKV>(f1, f1s, f2, f2s, fh, s1, s1s, s2, s2s, sh,
                                  a, stream);
  }
  if (hd == 64)
    return launch<float, 64, DKV>(f1, f1s, f2, f2s, fh, s1, s1s, s2, s2s, sh,
                                  a, stream);
  return launch<float, 128, DKV>(f1, f1s, f2, f2s, fh, s1, s1s, s2, s2s, sh,
                                 a, stream);
}

}  // namespace

// dQ of the flash prefill, and D = rowsum(dO o O) for the dK/dV kernel.
// q, o, dout: (b, t, heads, hd); k, v: (b, >= t, kv_heads, hd), the first t
// rows read; lse, dsum: (b, heads, t) f32 contiguous; dq: (b, t, heads, hd)
// f32. strides: eighteen element strides, (batch, token, head) of q, k, v,
// o, dout, dq; the last dimension is contiguous and every input row starts
// on a 16-byte boundary. is_bf16: 1 for bf16 inputs, 0 for f32. hd is 64 or
// 128.
extern "C" int flash_prefill_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const int* pad,
                                    const float* lse, float* dsum, float* dq,
                                    int b, int t, int heads, int kv_heads,
                                    int hd, int is_bf16,
                                    const long long* strides, float scale,
                                    cudaStream_t stream) {
  if (bad_shape(b, t, heads, kv_heads, hd)) return (int)cudaErrorInvalidValue;
  Strides s[6];
  unpack(strides, s);
  Args a{o, dout, s[3], s[4], pad, lse, dsum, dq, nullptr, s[5], s[5],
         b, t, heads, heads / kv_heads, 0, 1, scale};
  return dispatch<false>(is_bf16, hd, q, s[0], dout, s[4], heads, k, s[1], v,
                         s[2], kv_heads, a, stream);
}

// dK and dV of the flash prefill at kv_heads heads, after
// flash_prefill_bwd_dq has written dsum. q, dout: (b, t, heads, hd); k, v:
// (b, >= t, kv_heads, hd); dk, dv: f32 with k's (batch, token, head) layout,
// rows < t written. strides: eighteen, (batch, token, head) of q, k, v,
// dout, dk, dv.
extern "C" int flash_prefill_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const int* pad, const float* lse,
                                     const float* dsum, float* dk, float* dv,
                                     int b, int t, int heads, int kv_heads,
                                     int hd, int is_bf16,
                                     const long long* strides, float scale,
                                     cudaStream_t stream) {
  if (bad_shape(b, t, heads, kv_heads, hd)) return (int)cudaErrorInvalidValue;
  Strides s[6];
  unpack(strides, s);
  Args a{nullptr, nullptr, s[3], s[3], pad, lse, const_cast<float*>(dsum),
         dk, dv, s[4], s[5], b, t, heads, heads / kv_heads, 0, 1, scale};
  return dispatch<true>(is_bf16, hd, k, s[1], v, s[2], kv_heads, q, s[0],
                        dout, s[3], heads, a, stream);
}
