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
// Products, sums and the three gradients are f32 for f32 and bf16 inputs
// alike (the inputs are widened as they are loaded). Only the keys
// pad[b] <= j <= i are visited; pad rows and rows at or beyond t give
// exact zeros, never inf - inf (a masked probability is set to 0, not
// computed).
//
// Replaces the two backward Pallas kernels of the TPU flash attention that
// leafgrasp_tpu/vla/llava_jax.py _flash_prefill (:314) differentiates
// through: _flash_attention_bwd_dq (jax/experimental/pallas/ops/tpu/
// flash_attention.py:1287, pallas_call at :1456) and
// _flash_attention_bwd_dkv (:941, pallas_call at :1121). Their block
// structure is not carried over: there the grid is sequential and K/V are
// repeated to the query heads first.
//
// Bound: operations. At the training shape (2 rows of 642 tokens, 32 query
// heads over 8 K/V heads of 128) dK/dV take four products of
// 2 b heads hd t(t+1)/2 operations each and dQ three, on some 50 MB of
// inputs and outputs: far above the line where memory is the limit.
//
// Design: simple and right first. Both kernels are scalar f32 products over
// shared memory in 64 x 64 tiles, four warps a block, each thread owning two
// rows and sixteen columns of a tile's product as the f32 forward kernel of
// flash_prefill.cu does; a tile is loaded, widened to f32, then used, with no
// overlap of loads and products. Every output element is written by one
// thread from sums in a fixed order, so two runs give the same bits.
//
// flash_prefill_bwd_dq_kernel: one block for each (row b, query head, query
// tile of 64). Its prologue computes D for the tile's rows from dO and O and
// writes it out for the dK/dV kernel, which runs after it. It walks the key
// tiles from the pad's tile to the diagonal: S = Q K^T, P, dP = dO V^T,
// dS = P o (dP - D), dQ += dS K.
//
// flash_prefill_bwd_dkv_kernel: one block for each (row b, K/V head, key
// tile of 64). It walks the query tiles from the key tile's diagonal to t,
// and for each the rep query heads that share this K/V head, in a fixed
// order: S^T = K Q^T, P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q.
// The sum over the query-head group happens inside the block: no atomics
// and no per-query-head dK. dK and dV come out at kv_heads heads.
//
// What is left on the table: the tensor cores (wgmma) and overlap of loads
// with products; a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {                // in elements: batch, token, head
  long long b, t, h;
};

constexpr int BT = 64;          // rows of a tile: queries or keys
constexpr int NWARPS = 4;       // 16 rows a warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROW_PAD = 4;      // 16 bytes: rows fall into different banks
constexpr int SC_LD = BT + 4;   // scratch row of P or dS

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
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* dst) {
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

// rows [row0, row0 + BT) of a (rows, HD) global tile, widened to f32, into
// shared memory with row stride HD + ROW_PAD; rows at or beyond `limit`
// become zeros and are never read
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int limit) {
  constexpr int V = Vec<T>::N;
  constexpr int CH = HD / V;
  constexpr int LD = HD + ROW_PAD;
  for (int idx = threadIdx.x; idx < BT * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    const int row = row0 + r;
    float x[V];
    if (row < limit) {
      Vec<T>::load(src + (long long)row * row_stride + c * V, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.0f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * LD + c * V);
#pragma unroll
    for (int e = 0; e < V / 4; ++e)
      d[e] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2], x[4 * e + 3]);
  }
}

// s[n][e] = A[row] . B[col] over HD, for the thread's rows ra (e < 2) and
// ra + 8 (e >= 2) of A and the columns 8n + 2tq + (e & 1) (rows of B)
template <int HD>
__device__ __forceinline__ void rows_dot(float (&s)[8][4], const float* A,
                                         const float* B, int ra, int tq) {
  constexpr int LD = HD + ROW_PAD;
  const float* a0 = A + ra * LD;
  const float* a1 = a0 + 8 * LD;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float* b0 = B + (n * 8 + 2 * tq) * LD;
    const float* b1 = b0 + LD;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      s0 += a0[d] * b0[d];
      s1 += a0[d] * b1[d];
      s2 += a1[d] * b0[d];
      s3 += a1[d] * b1[d];
    }
    s[n][0] = s0;
    s[n][1] = s1;
    s[n][2] = s2;
    s[n][3] = s3;
  }
}

// acc[d][e] += sum_j M[r][j] B[j][8d + 2tq + (e & 1)] for r = the thread's
// row (ma, e < 2) and the one 8 below (mb, e >= 2); M rows in the scratch
template <int HD>
__device__ __forceinline__ void rows_times(float (&acc)[HD / 8][4],
                                           const float* ma, const float* mb,
                                           const float* B, int tq) {
  constexpr int LD = HD + ROW_PAD;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const float* bp = B + d * 8 + 2 * tq;
    float a0 = acc[d][0], a1 = acc[d][1], a2 = acc[d][2], a3 = acc[d][3];
#pragma unroll 8
    for (int j = 0; j < BT; ++j) {
      const float x = bp[j * LD], y = bp[j * LD + 1];
      a0 += ma[j] * x;
      a1 += ma[j] * y;
      a2 += mb[j] * x;
      a3 += mb[j] * y;
    }
    acc[d][0] = a0;
    acc[d][1] = a1;
    acc[d][2] = a2;
    acc[d][3] = a3;
  }
}

// the thread's fragment into its warp's 16 scratch rows
__device__ __forceinline__ void to_scratch(float* pw, const float (&s)[8][4],
                                           int g, int tq) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    pw[g * SC_LD + n * 8 + 2 * tq] = s[n][0];
    pw[g * SC_LD + n * 8 + 2 * tq + 1] = s[n][1];
    pw[(g + 8) * SC_LD + n * 8 + 2 * tq] = s[n][2];
    pw[(g + 8) * SC_LD + n * 8 + 2 * tq + 1] = s[n][3];
  }
}

template <int HD>
__device__ __forceinline__ void zero(float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
}

// rows ra and ra + 8 of a (rows, HD) f32 output, times `mul`, for rows < t
template <int HD>
__device__ __forceinline__ void store_rows(float* dst, long long row_stride,
                                           const float (&acc)[HD / 8][4],
                                           int row_a, int t, int tq,
                                           float mul) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = d * 8 + 2 * tq;
    if (row_a < t)
      *reinterpret_cast<float2*>(dst + (long long)row_a * row_stride + col) =
          make_float2(acc[d][0] * mul, acc[d][1] * mul);
    if (row_b < t)
      *reinterpret_cast<float2*>(dst + (long long)row_b * row_stride + col) =
          make_float2(acc[d][2] * mul, acc[d][3] * mul);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return ((size_t)4 * BT * (HD + ROW_PAD) + (size_t)BT * SC_LD + 2 * BT)
         * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_prefill_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ o,
                            const T* __restrict__ dout,
                            const int* __restrict__ pad,
                            const float* __restrict__ lse,
                            float* __restrict__ dsum, float* __restrict__ dq,
                            int t, int rep, Strides qs, Strides ks,
                            Strides vs, Strides os, Strides dos,
                            Strides dqs, float scale) {
  constexpr int LD = HD + ROW_PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + BT * LD;
  float* Ks = dOs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* Sc = Vs + BT * LD;
  float* lse_s = Sc + BT * SC_LD;
  float* D_s = lse_s + BT;

  const int b = blockIdx.z, h = blockIdx.y, heads = gridDim.y;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int p = min(max(pad[b], 0), t);
  const int row_hi = min(q0 + BT, t);
  const long long lrow = ((long long)b * heads + h) * t;

  const T* kb = k + b * ks.b + (h / rep) * ks.h;
  const T* vb = v + b * vs.b + (h / rep) * vs.h;

  // ---- prologue: Q, dO, and O (in the K buffer) for D = rowsum(dO o O)
  load_tile<T, HD>(Qs, q + b * qs.b + h * qs.h, qs.t, q0, t);
  load_tile<T, HD>(dOs, dout + b * dos.b + h * dos.h, dos.t, q0, t);
  load_tile<T, HD>(Ks, o + b * os.b + h * os.h, os.t, q0, t);
  __syncthreads();
  for (int r = warp; r < BT; r += NWARPS) {
    float acc = 0.0f;
    for (int d = lane; d < HD; d += 32) acc += dOs[r * LD + d] * Ks[r * LD + d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const bool in = q0 + r < row_hi;
      D_s[r] = acc;
      lse_s[r] = in ? lse[lrow + q0 + r] : -INFINITY;
      if (in) dsum[lrow + q0 + r] = acc;
    }
  }
  __syncthreads();

  float acc[HD / 8][4];
  zero<HD>(acc);
  const int ra = warp * 16 + g;               // this thread's rows: ra, ra+8
  const int row_a = q0 + ra, row_b = row_a + 8;
  const float la = lse_s[ra], lb = lse_s[ra + 8];
  const float da = D_s[ra], db = D_s[ra + 8];
  const int warp_last = q0 + warp * 16 + 15;  // the warp's last query row
  if (row_hi > p) {                           // a real row: keys to visit
    const int kt_first = p / BT, kt_last = (row_hi - 1) / BT;
    for (int kt = kt_first; kt <= kt_last; ++kt) {
      const int k0 = kt * BT;
      load_tile<T, HD>(Ks, kb, ks.t, k0, t);
      load_tile<T, HD>(Vs, vb, vs.t, k0, t);
      __syncthreads();
      if (k0 <= warp_last) {                  // else above the diagonal
        float s[8][4], dp[8][4];
        rows_dot<HD>(s, Qs, Ks, ra, tq);      // S = Q K^T
        rows_dot<HD>(dp, dOs, Vs, ra, tq);    // dP = dO V^T
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = k0 + n * 8 + 2 * tq + (e & 1);
            const int i = (e < 2) ? row_a : row_b;
            const bool ok = (j >= p) && (j <= i) && (i < t);
            const float pr = ok ? expf(fmaf(s[n][e], scale,
                                            -((e < 2) ? la : lb)))
                                : 0.0f;
            s[n][e] = pr * (dp[n][e] - ((e < 2) ? da : db));  // dS
          }
        }
        float* pw = Sc + warp * 16 * SC_LD;
        to_scratch(pw, s, g, tq);
        __syncwarp();
        rows_times<HD>(acc, pw + g * SC_LD, pw + (g + 8) * SC_LD, Ks, tq);
        __syncwarp();
      }
      __syncthreads();                        // K, V may be overwritten
    }
  }
  store_rows<HD>(dq + b * dqs.b + h * dqs.h, dqs.t, acc, row_a, t, tq, scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_prefill_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const int* __restrict__ pad,
                             const float* __restrict__ lse,
                             const float* __restrict__ dsum,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int t, int rep, Strides qs, Strides ks,
                             Strides vs, Strides dos, Strides dks,
                             Strides dvs, float scale) {
  constexpr int LD = HD + ROW_PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* Sc = dOs + BT * LD;
  float* lse_s = Sc + BT * SC_LD;
  float* D_s = lse_s + BT;

  const int b = blockIdx.z, kvh = blockIdx.y, kv_heads = gridDim.y;
  const int heads = kv_heads * rep;
  const int kt = blockIdx.x;                  // the first tiles are heaviest
  const int k0 = kt * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int p = min(max(pad[b], 0), t);

  load_tile<T, HD>(Ks, k + b * ks.b + kvh * ks.h, ks.t, k0, t);
  load_tile<T, HD>(Vs, v + b * vs.b + kvh * vs.h, vs.t, k0, t);

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
  zero<HD>(acc_k);
  zero<HD>(acc_v);
  const int ra = warp * 16 + g;               // this thread's keys: ra, ra+8
  const int key_a = k0 + ra, key_b = key_a + 8;
  const int warp_first = k0 + warp * 16;      // the warp's first key
  float* pw = Sc + warp * 16 * SC_LD;
  const float* pa = pw + g * SC_LD;
  const float* pb = pa + 8 * SC_LD;

  // queries i >= j >= k0 and i >= p; nothing to do where every key is pad
  const int qt_first = max(kt, p / BT), qt_last = (t - 1) / BT;
  if (k0 + BT - 1 >= p) {
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int q0 = qt * BT;
      for (int r = 0; r < rep; ++r) {
        const int h = kvh * rep + r;
        const long long lrow = ((long long)b * heads + h) * t;
        __syncthreads();                      // the last tiles are read
        load_tile<T, HD>(Qs, q + b * qs.b + h * qs.h, qs.t, q0, t);
        load_tile<T, HD>(dOs, dout + b * dos.b + h * dos.h, dos.t, q0, t);
        for (int c = threadIdx.x; c < BT; c += NTHREADS) {
          const bool in = q0 + c < t;
          lse_s[c] = in ? lse[lrow + q0 + c] : -INFINITY;
          D_s[c] = in ? dsum[lrow + q0 + c] : 0.0f;
        }
        __syncthreads();
        if (warp_first > q0 + BT - 1) continue;  // keys after every query
        float s[8][4];
        rows_dot<HD>(s, Ks, Qs, ra, tq);      // S^T = K Q^T
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = n * 8 + 2 * tq + (e & 1);
            const int i = q0 + c;
            const int j = (e < 2) ? key_a : key_b;
            const bool ok = (j >= p) && (j <= i) && (i < t);
            s[n][e] = ok ? expf(fmaf(s[n][e], scale, -lse_s[c])) : 0.0f;
          }
        }
        to_scratch(pw, s, g, tq);             // P^T
        __syncwarp();
        rows_times<HD>(acc_v, pa, pb, dOs, tq);   // dV += P^T dO
        rows_dot<HD>(s, Vs, dOs, ra, tq);     // dP^T = V dO^T
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = n * 8 + 2 * tq + (e & 1);
            const float pr = (e < 2) ? pa[c] : pb[c];
            s[n][e] = pr * (s[n][e] - D_s[c]);  // dS^T
          }
        }
        __syncwarp();                         // P^T is read by the warp
        to_scratch(pw, s, g, tq);
        __syncwarp();
        rows_times<HD>(acc_k, pa, pb, Qs, tq);    // dK += dS^T Q
        __syncwarp();
      }
    }
  }
  store_rows<HD>(dk + b * dks.b + kvh * dks.h, dks.t, acc_k, key_a, t, tq,
                 scale);
  store_rows<HD>(dv + b * dvs.b + kvh * dvs.h, dvs.t, acc_v, key_a, t, tq,
                 1.0f);
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const int* pad, const float* lse, float* dsum,
              float* dq, int b, int t, int heads, int rep, const Strides* s,
              float scale, cudaStream_t stream) {
  auto kernel = flash_prefill_bwd_dq_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + BT - 1) / BT, heads, b);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), pad, lse, dsum, dq, t, rep, s[0], s[1],
      s[2], s[3], s[4], s[5], scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const int* pad, const float* lse, const float* dsum, float* dk,
               float* dv, int b, int t, int kv_heads, int rep,
               const Strides* s, float scale, cudaStream_t stream) {
  auto kernel = flash_prefill_bwd_dkv_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + BT - 1) / BT, kv_heads, b);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), pad, lse, dsum,
      dk, dv, t, rep, s[0], s[1], s[2], s[3], s[4], s[5], scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int b, int t, int heads, int kv_heads, int hd) {
  return b <= 0 || t <= 0 || heads <= 0 || kv_heads <= 0
         || heads % kv_heads != 0 || (hd != 64 && hd != 128);
}

void unpack(const long long* strides, Strides* s) {
  for (int i = 0; i < 6; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
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
  const int rep = heads / kv_heads;
  if (is_bf16) {
    if (hd == 64)
      return launch_dq<__nv_bfloat16, 64>(q, k, v, o, dout, pad, lse, dsum,
                                          dq, b, t, heads, rep, s, scale,
                                          stream);
    return launch_dq<__nv_bfloat16, 128>(q, k, v, o, dout, pad, lse, dsum, dq,
                                         b, t, heads, rep, s, scale, stream);
  }
  if (hd == 64)
    return launch_dq<float, 64>(q, k, v, o, dout, pad, lse, dsum, dq, b, t,
                                heads, rep, s, scale, stream);
  return launch_dq<float, 128>(q, k, v, o, dout, pad, lse, dsum, dq, b, t,
                               heads, rep, s, scale, stream);
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
  const int rep = heads / kv_heads;
  if (is_bf16) {
    if (hd == 64)
      return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, pad, lse, dsum, dk,
                                           dv, b, t, kv_heads, rep, s, scale,
                                           stream);
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, pad, lse, dsum, dk,
                                          dv, b, t, kv_heads, rep, s, scale,
                                          stream);
  }
  if (hd == 64)
    return launch_dkv<float, 64>(q, k, v, dout, pad, lse, dsum, dk, dv, b, t,
                                 kv_heads, rep, s, scale, stream);
  return launch_dkv<float, 128>(q, k, v, dout, pad, lse, dsum, dk, dv, b, t,
                                kv_heads, rep, s, scale, stream);
}
