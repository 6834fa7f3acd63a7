// The grouped-query attention of one decode step, over the K/V cache as
// it lies:
//   out[b, h] = sum_j p[b, h, j] v[b, j, h / rep]
//   p[b, h, j] = round(exp(s_j - M) / L),  s_j = (q[b, h] . k[b, j, h / rep])
//                                               * (1 / sqrt(hd))
// over the live keys max(pad[b], pos - window + 1) <= j <= pos, where
// pos is the step's slot, read from the device (``cursor``) at every
// launch, so a captured CUDA graph serves any prompt that fits the cache.
// Scores, M (the row's max), L (its sum of exponentials) and the sums of
// P.V are f32; p is rounded to the layer's type (bf16) after the
// division by L, as the dense route's ``softmax(...).to(dt)`` rounds it;
// the output is rounded once, to the promoted type of that type and the
// cache's. q is (b, 1, heads, hd); k and v are (b, capacity, kv_heads,
// hd) with any row, slot and head strides (16-byte rows), never repeated
// to the query heads, so any heads that are a multiple of kv_heads work.
//
// Replaces no TPU kernel: the JAX decode is the grouped einsum of
// leafgrasp_tpu/vla/llava_jax.py:355-379, which XLA fuses on the TPU.
// The port's dense route ran it as eight launches over every slot of the
// rounded capacity: the whole cache cast to f32, permuted copies of K
// and V, an f32 product, the scale, a masked fill, the softmax and a
// cast, and a bf16 product.
//
// Bound: bytes. A step reads each live key's K and V row once; at the
// 7B cell (5 rows, 2400 live slots, 8 K/V heads of 128 in bf16) that is
// 49 MB a layer, 14.7 us at 3.35 TB/s; q, the scores (1.5 MB, f32) and
// the partial sums stay in L2. The products are 2 * 32 * 128 FLOP a key
// and row, far below the card's rate on CUDA cores.
//
// Design. 40 (row, K/V head) pairs do not fill 132 SMs, so the key axis
// is split: each of n_split blocks of a pair takes an equal share of the
// row's live keys. The wrapper picks n_split from the capacity and the SM
// count (never from the cursor) so that every block of a launch is
// resident at once (four an SM): a second wave would nearly double a
// launch. What else holds a block back is what waits on the rows: a load
// that a block issues after its SM's stream of row loads queues behind
// them. So each block first asks for its small inputs (the cursor and its
// row's pad, then its query heads, or its scores and the row's (max, sum)
// pairs), then streams its rows through registers: every lane keeps 128
// bytes of rows in flight, and refills each 16-byte slot with the next
// round's row as soon as it has used it (a rolling prefetch: one buffer of
// registers, never idle). The rounding of p needs the row's exact M and L
// before any P.V, so the step is two launches, each deterministic (no
// float atomics; every sum in a fixed order, so a graph replay and an
// eager step give the same bits):
// 1. scores: 8 lanes take a key row (16 bytes each; a 3-step butterfly
//    sums a key's products for the <= DA_HEADS query heads of its K/V
//    head, held in registers). A block writes its scaled scores and its
//    share's (max, sum of exp); its pair's first share zeroes the pair's
//    ticket.
// 2. pv: a block merges the row's (max, sum) pairs into M and L in share
//    order, turns its scores into rounded p in shared memory, and sums p v
//    (a 16-byte piece of a V row a thread); the key lanes' sums meet in
//    shared memory, in order, and leave as one f32 partial a share. The
//    pair's last block to finish (an integer ticket) adds the partials in
//    share order and rounds once.
// Slots outside a row's live keys are never read, so whatever they hold
// (zeros, a NaN, an older prompt) cannot reach the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DA_THREADS 128     // four warps a block
#define DA_HEADS 4         // query heads a block: one K/V head's, or part
#define DA_MAX_CHUNK 256   // live keys a share at most

using bf16 = __nv_bfloat16;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* pad;
  const long long* cursor;
  void* out;
  float* scores;   // (b, heads, capacity): the live slots' scaled scores
  float* ml;       // (b, heads, n_split, 2): a share's max and sum
  float* part;     // (n_split, b, heads, hd): a share's sum of p v
  int* ticket;     // (b, kv_heads * groups): the pair's finished shares
  long long q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;  // elements
  int b, heads, kv_heads, cap, rep, groups, n_split, window;
  float scale;
  int q_bf16, p_bf16, out_bf16;
};

struct Range {
  int k0, k1;
};

// The live keys of ``row`` that share ``s`` takes: [k0, k1).
__device__ __forceinline__ Range share_range(const DecodeArgs& a, int row,
                                             int s) {
  const long long pos = a.cursor[0];
  long long hi = pos + 1;
  if (hi > a.cap) hi = a.cap;
  long long lo = a.pad[row];
  if (a.window > 0 && pos - a.window + 1 > lo) lo = pos - a.window + 1;
  if (lo < 0) lo = 0;
  long long n = hi - lo;
  if (n < 0) n = 0;
  const long long chunk = (n + a.n_split - 1) / a.n_split;
  long long k0 = lo + s * chunk;
  long long k1 = k0 + chunk;
  if (k1 > hi) k1 = hi;
  if (k0 > k1) k0 = k1;
  return {(int)k0, (int)k1};
}

__device__ __forceinline__ uint4 ld16(const char* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes of a row as floats (bf16 to f32 is exact: a shift).
__device__ __forceinline__ void unpack(uint4 u, float* f, bf16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(uint4 u, float* f, float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// A butterfly: every lane ends with the same bits (a + b == b + a).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The block's place: (share, row, K/V head, its first query head, heads,
// its pair's index).
struct Place {
  int s, row, kvh, h0, nr, pair;
};

__device__ __forceinline__ Place place(const DecodeArgs& a) {
  Place p;
  p.s = blockIdx.x;
  p.row = blockIdx.z;
  p.kvh = blockIdx.y / a.groups;
  const int g = blockIdx.y % a.groups;
  p.h0 = p.kvh * a.rep + g * DA_HEADS;
  p.nr = min(DA_HEADS, a.rep - g * DA_HEADS);
  p.pair = blockIdx.z * gridDim.y + blockIdx.y;
  return p;
}

template <typename T, int HD>
__global__ void __launch_bounds__(DA_THREADS, 4)
    decode_attention_scores_kernel(DecodeArgs a) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements in 16 bytes
  constexpr int CH = HD / EPC;              // 16-byte pieces a row
  constexpr int LPK = 8;                    // lanes a key
  constexpr int C = CH / LPK;               // pieces a lane
  constexpr int E = C * EPC;                // elements a lane
  constexpr int U = 8 / C;                  // rounds in flight
  constexpr int KPB = 4 * (DA_THREADS / 32);  // keys a round
  constexpr int QN = DA_HEADS * HD / DA_THREADS;
  static_assert(C >= 1 && C * LPK == CH, "head size");

  __shared__ float qs[DA_HEADS][HD];
  __shared__ float ss[DA_HEADS][DA_MAX_CHUNK];
  const Place pl = place(a);
  const Range r = share_range(a, pl.row, pl.s);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = lane & 7, sub = lane >> 3;
  const char* kb = reinterpret_cast<const char*>(a.k)
      + ((long long)pl.row * a.k_sb + (long long)pl.kvh * a.k_sh)
          * (long long)sizeof(T);
  const long long kst = a.k_st * (long long)sizeof(T);

  // q first: a load issued after the rows would queue behind them
  float qv[QN];
#pragma unroll
  for (int u = 0; u < QN; ++u) {
    const int h = (tid + u * DA_THREADS) / HD, d = (tid + u * DA_THREADS) % HD;
    const long long o = (long long)pl.row * a.q_sb
        + (long long)(pl.h0 + h) * a.q_sh + d;
    qv[u] = h >= pl.nr ? 0.f
        : a.q_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(a.q)[o])
                   : reinterpret_cast<const float*>(a.q)[o];
  }
  // round u of the rolling window holds key it + u * KPB + warp * 4 + sub
  uint4 raw[U][C];
  auto load = [&](int u, int it) {
    const int j = it + u * KPB + warp * 4 + sub;
#pragma unroll
    for (int c = 0; c < C; ++c)
      raw[u][c] = j < r.k1 ? ld16(kb + j * kst + (part + c * LPK) * 16)
                           : make_uint4(0u, 0u, 0u, 0u);
  };
#pragma unroll
  for (int u = 0; u < U; ++u) load(u, r.k0);
  if (pl.s == 0 && tid == 0) a.ticket[pl.pair] = 0;
#pragma unroll
  for (int u = 0; u < QN; ++u)
    qs[(tid + u * DA_THREADS) / HD][(tid + u * DA_THREADS) % HD] = qv[u];
  __syncthreads();
  float qr[DA_HEADS][E];
#pragma unroll
  for (int h = 0; h < DA_HEADS; ++h)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        qr[h][c * EPC + e] = qs[h][(part + c * LPK) * EPC + e];

  for (int it = r.k0; it < r.k1; it += U * KPB) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = it + u * KPB + warp * 4 + sub;
      float dot[DA_HEADS];
#pragma unroll
      for (int h = 0; h < DA_HEADS; ++h) dot[h] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float kf[EPC];
        unpack(raw[u][c], kf, static_cast<T*>(nullptr));
#pragma unroll
        for (int h = 0; h < DA_HEADS; ++h)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            dot[h] = fmaf(qr[h][c * EPC + e], kf[e], dot[h]);
      }
      load(u, it + U * KPB);   // the slot's next row, while this one sums
#pragma unroll
      for (int h = 0; h < DA_HEADS; ++h)
#pragma unroll
        for (int off = 1; off < LPK; off <<= 1)
          dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], off);
      if (j < r.k1 && part < pl.nr) {
        float sc = dot[0];
#pragma unroll
        for (int h = 1; h < DA_HEADS; ++h)
          if (part == h) sc = dot[h];
        sc *= a.scale;
        ss[part][j - r.k0] = sc;
        a.scores[((long long)pl.row * a.heads + pl.h0 + part) * a.cap + j] =
            sc;
      }
    }
  }
  __syncthreads();

  // the share's max and sum of exponentials, a warp a query head
  if (warp < pl.nr) {
    const int nk = r.k1 - r.k0;
    float m = -INFINITY;
    for (int i = lane; i < nk; i += 32) m = fmaxf(m, ss[warp][i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < nk; i += 32) l += expf(ss[warp][i] - m);
    l = warp_sum(l);
    if (lane == 0) {
      float* o = a.ml
          + (((long long)pl.row * a.heads + pl.h0 + warp) * a.n_split + pl.s)
              * 2;
      o[0] = m;
      o[1] = l;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(DA_THREADS, 4)
    decode_attention_pv_kernel(DecodeArgs a) {
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int CH = HD / EPC;             // 16-byte pieces a row
  constexpr int KP = DA_THREADS / CH;      // keys summed side by side
  constexpr int U = 8;                     // rounds in flight
  constexpr int SN = DA_HEADS * DA_MAX_CHUNK / DA_THREADS;
  static_assert(KP * CH == DA_THREADS, "head size");

  __shared__ float ps[DA_HEADS][DA_MAX_CHUNK];
  __shared__ float red[KP][DA_HEADS][HD];
  __shared__ float stat[DA_HEADS][2];
  __shared__ int last;
  const Place pl = place(a);
  const Range r = share_range(a, pl.row, pl.s);
  const int nk = r.k1 - r.k0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % CH, kl = tid / CH;
  const char* vb = reinterpret_cast<const char*>(a.v)
      + ((long long)pl.row * a.v_sb + (long long)pl.kvh * a.v_sh)
          * (long long)sizeof(T)
      + c * 16;
  const long long vst = a.v_st * (long long)sizeof(T);

  // the first 32 shares' (max, sum) pairs and this share's scores first: a
  // load issued after the rows would queue behind them
  const bool mine = warp < pl.nr;
  const float* ml = a.ml
      + ((long long)pl.row * a.heads + pl.h0 + (mine ? warp : 0)) * a.n_split
          * 2;
  const float m0 = mine && lane < a.n_split ? ml[2 * lane] : -INFINITY;
  const float l0 = mine && lane < a.n_split ? ml[2 * lane + 1] : 0.f;
  float sc[SN];
#pragma unroll
  for (int u = 0; u < SN; ++u) {
    const int i = tid + u * DA_THREADS;
    const int h = i / max(nk, 1), j = i % max(nk, 1);
    sc[u] = i < DA_HEADS * nk && h < pl.nr
        ? a.scores[((long long)pl.row * a.heads + pl.h0 + h) * a.cap + r.k0
                   + j]
        : 0.f;
  }
  // round u of the rolling window holds key it + u * KP
  uint4 raw[U];
  auto load = [&](int u, int it) {
    const int j = it + u * KP;
    raw[u] = j < r.k1 ? ld16(vb + j * vst) : make_uint4(0u, 0u, 0u, 0u);
  };
#pragma unroll
  for (int u = 0; u < U; ++u) load(u, r.k0 + kl);

  // M and L of the row, merged over the shares in share order
  if (mine) {
    float m = m0;
    for (int i = lane + 32; i < a.n_split; i += 32) m = fmaxf(m, ml[2 * i]);
    m = warp_max(m);
    float l = l0 > 0.f ? l0 * expf(m0 - m) : 0.f;
    for (int i = lane + 32; i < a.n_split; i += 32) {
      const float li = ml[2 * i + 1];
      if (li > 0.f) l += li * expf(ml[2 * i] - m);
    }
    l = warp_sum(l);
    if (lane == 0) {
      stat[warp][0] = m;
      stat[warp][1] = l;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < SN; ++u) {
    const int i = tid + u * DA_THREADS;
    if (i < DA_HEADS * nk) {
      const int h = i / nk, j = i % nk;
      float p = 0.f;
      if (h < pl.nr) {
        p = expf(sc[u] - stat[h][0]) / stat[h][1];
        if (a.p_bf16) p = __bfloat162float(__float2bfloat16_rn(p));
      }
      ps[h][j] = p;
    }
  }
  __syncthreads();

  float acc[DA_HEADS][EPC];
#pragma unroll
  for (int h = 0; h < DA_HEADS; ++h)
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[h][e] = 0.f;
  for (int it = r.k0 + kl; it < r.k1; it += U * KP) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = it + u * KP;
      float vf[EPC];
      unpack(raw[u], vf, static_cast<T*>(nullptr));
      load(u, it + U * KP);    // the slot's next row, while this one sums
      if (j < r.k1) {
#pragma unroll
        for (int h = 0; h < DA_HEADS; ++h) {
          const float p = ps[h][j - r.k0];
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[h][e] = fmaf(p, vf[e], acc[h][e]);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < DA_HEADS; ++h)
#pragma unroll
    for (int e = 0; e < EPC; ++e) red[kl][h][c * EPC + e] = acc[h][e];
  __syncthreads();
  const long long stride = (long long)a.b * a.heads * HD;
  const long long o0 = ((long long)pl.row * a.heads + pl.h0) * HD;
  for (int i = tid; i < pl.nr * HD; i += DA_THREADS) {
    const int h = i / HD, d = i % HD;
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < KP; ++t) sum += red[t][h][d];
    a.part[pl.s * stride + o0 + i] = sum;
  }

  // the pair's last share to finish adds the partials, in share order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.ticket + pl.pair, 1) == a.n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < pl.nr * HD; i += DA_THREADS) {
    float sum = 0.f;
    for (int s = 0; s < a.n_split; ++s)
      sum += __ldcg(a.part + s * stride + o0 + i);
    if (a.out_bf16)
      reinterpret_cast<bf16*>(a.out)[o0 + i] = __float2bfloat16_rn(sum);
    else
      reinterpret_cast<float*>(a.out)[o0 + i] = sum;
  }
}

template <typename T, int HD>
static int launch(const DecodeArgs& a, cudaStream_t stream) {
  const dim3 grid(a.n_split, a.kv_heads * a.groups, a.b);
  decode_attention_scores_kernel<T, HD><<<grid, DA_THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attention_pv_kernel<T, HD><<<grid, DA_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

static long long up4(long long n) { return (n + 3) & ~3LL; }

// strides: q (row, head), k (row, slot, head), v (row, slot, head), in
// elements. work: the scores, the (max, sum) pairs and the partials as
// floats, each from a 16-byte boundary, then the tickets:
// up4(b heads cap) + up4(b heads n_split 2) + up4(n_split b heads hd)
// + b kv_heads groups floats.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* pad, const long long* cursor,
                                void* out, float* work, int b, int heads,
                                int kv_heads, int cap, int hd, int kv_bf16,
                                int q_bf16, int p_bf16, int out_bf16,
                                int n_split, int window,
                                const long long* strides, float scale,
                                cudaStream_t stream) {
  if (b < 1 || kv_heads < 1 || heads % kv_heads != 0 || cap < 1
      || n_split < 1 || (long long)n_split * DA_MAX_CHUNK < cap
      || window < 0 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.pad = pad;
  a.cursor = cursor;
  a.out = out;
  a.scores = work;
  a.ml = a.scores + up4((long long)b * heads * cap);
  a.part = a.ml + up4((long long)b * heads * n_split * 2);
  a.ticket = reinterpret_cast<int*>(
      a.part + up4((long long)n_split * b * heads * hd));
  a.q_sb = strides[0];
  a.q_sh = strides[1];
  a.k_sb = strides[2];
  a.k_st = strides[3];
  a.k_sh = strides[4];
  a.v_sb = strides[5];
  a.v_st = strides[6];
  a.v_sh = strides[7];
  a.b = b;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.cap = cap;
  a.rep = heads / kv_heads;
  a.groups = (a.rep + DA_HEADS - 1) / DA_HEADS;
  a.n_split = n_split;
  a.window = window;
  a.scale = scale;
  a.q_bf16 = q_bf16;
  a.p_bf16 = p_bf16;
  a.out_bf16 = out_bf16;
  if (kv_bf16)
    return hd == 64 ? launch<bf16, 64>(a, stream) : launch<bf16, 128>(a, stream);
  return hd == 64 ? launch<float, 64>(a, stream) : launch<float, 128>(a, stream);
}
