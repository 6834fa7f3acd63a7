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
// Pallas TPU flash attention with causal=True and segment ids.
//
// Bound: operations. A launch at the serving shape (5 rows of 2400
// tokens, 32 heads of 128) does 4 * b * heads * hd * t(t+1)/2 = 2.4e11
// operations on 0.2 GB of inputs and outputs: about 1200 operations a
// byte, four times above the line where the tensor cores and not the
// memory are the limit. Design: the TPU wrapper pads the sequence to a
// block multiple, repeats K and V to the query head count and hands
// (block_q, block_k) tiles of 512 to a sequential grid. Here one block of
// four warps owns 64 query rows of one head (16 rows a warp) and walks
// the key tiles of 64 from the pad's tile up to its diagonal, so the
// masked half of the square and the pad prefix are never visited; the
// ragged last tile is zero-filled on load and masked, nothing is padded
// on the host; the K/V head is h / rep, read through the strides the
// caller gives (the cache tensor as it is, no repeat and no copy). The
// bf16 products are mma.sync m16n8k16 tiles with f32 accumulators; the
// score fragment of a warp is already laid out as the A operand of the
// second product, so probabilities never leave registers. Row maxima and
// sums are kept per thread quad (the four lanes that share a row of the
// fragment). Q and the K/V tiles arrive through cp.async, K/V into two
// shared-memory stages, so the next tile loads while this one is multiplied; K and V
// fragments come out of shared memory with ldmatrix (four 8x8 blocks an
// instruction); tiles that lie wholly inside the causal triangle and
// behind the pad skip the mask; the exponentials are exp2f with log2(e)
// folded into the score scale. Blocks start heaviest first (last
// query tile first). wgmma, TMA and a K/V tile shared by the rep heads
// of a group are left for later.
//
// The f32 instantiation runs the same tile walk, masking, running
// softmax and epilogue with the two products as scalar loops over shared
// memory (f32 has no exact tensor-core form); it exists to hold the
// masking and the softmax against the plain version to about 1e-5.
//
// This file is built with fused multiply-adds allowed (the other kernels
// are not); exp2f is the accurate form, there is no --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;          // query rows a block (16 a warp)
constexpr int BN = 64;          // keys a tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PS_LD = BN + 4;   // f32 probability scratch row (f32 only)

// shared-memory row padding: 16 bytes, so that the eight rows a fragment
// load touches fall into different banks
template <typename T> struct RowPad { static constexpr int v = 16 / sizeof(T); };

struct Strides {                // in elements: batch, token, head
  long long b, t, h;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// four transposed 8x8 b16 matrices: lane l gives the address of row l % 8
// of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* ptr) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(ptr);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* ptr) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(ptr);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared without passing registers; src_bytes 0 writes
// zeros and reads nothing
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + nrows) of a (rows, HD) global tile into shared
// memory through cp.async, 16 bytes a thread: returns at once, the copy
// lands later; rows outside [0, limit) become zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long row_stride,
                                                int row0, int nrows,
                                                int limit) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = HD / VEC;
  constexpr int LD = HD + RowPad<T>::v;
  for (int idx = threadIdx.x; idx < nrows * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    const int row = row0 + r;
    const bool ok = row >= 0 && row < limit;
    cp_async_16(dst + r * LD + c * VEC,
                src + (long long)(ok ? row : 0) * row_stride + c * VEC,
                ok ? 16 : 0);
  }
}

template <typename T> __device__ __forceinline__ void store_pair(T* p, float a,
                                                                 float b);
template <> __device__ __forceinline__ void store_pair<float>(float* p, float a,
                                                              float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store_pair<__nv_bfloat16>(
    __nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ pad,
                     T* __restrict__ out, int t, int rep, Strides qs,
                     Strides ks, Strides vs, Strides os, float scale) {
  constexpr bool kScalar = std::is_same<T, float>::value;
  constexpr int LD = HD + RowPad<T>::v;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Kst = Qs + BM * LD;                      // two stages of BN rows
  T* Vst = Kst + 2 * BN * LD;
  float* Ps = reinterpret_cast<float*>(Vst + 2 * BN * LD);   // f32 only

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int p = min(max(pad[b], 0), t);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / rep) * ks.h;
  const T* vb = v + b * vs.b + (h / rep) * vs.h;
  T* ob = out + b * os.b + h * os.h;

  const int row_hi = min(q0 + BM, t);         // rows of this block: < row_hi
  if (row_hi <= p) {                          // pad rows only: zeros
    for (int idx = threadIdx.x; idx < (row_hi - q0) * (HD / 2);
         idx += NTHREADS) {
      const int r = idx / (HD / 2), c = idx % (HD / 2);
      store_pair<T>(ob + (long long)(q0 + r) * os.t + 2 * c, 0.0f, 0.0f);
    }
    return;
  }

  const int kt_first = p / BN;
  const int kt_last = (row_hi - 1) / BN;
  load_tile_async<T, HD>(Qs, qb, qs.t, q0, BM, t);
  cp_async_commit();
  load_tile_async<T, HD>(Kst, kb, ks.t, kt_first * BN, BN, t);
  load_tile_async<T, HD>(Vst, vb, vs.t, kt_first * BN, BN, t);
  cp_async_commit();
  cp_async_wait<1>();                         // Q has landed
  __syncthreads();

  const int lr = warp * 16 + g;               // this thread's rows: lr, lr+8
  const int row_a = q0 + lr, row_b = row_a + 8;
  const int warp_first = q0 + warp * 16;      // query rows of the warp
  const int warp_last = warp_first + 15;
  const float scale2 = scale * 1.4426950408889634f;   // to log2 units

  uint32_t qf[kScalar ? 1 : HD / 16][4];
  if constexpr (!kScalar) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const T* base = Qs + lr * LD + kk * 16 + 2 * tq;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
    }
  }

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY;     // running row maxima
  float l_a = 0.0f, l_b = 0.0f;               // this thread's share of sums

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * BN;
    const int stage = (kt - kt_first) & 1;
    const T* Ks = Kst + stage * BN * LD;
    const T* Vs = Vst + stage * BN * LD;
    if (kt < kt_last) {                       // prefetch the next tile
      load_tile_async<T, HD>(Kst + (stage ^ 1) * BN * LD, kb, ks.t, k0 + BN,
                             BN, t);
      load_tile_async<T, HD>(Vst + (stage ^ 1) * BN * LD, vb, vs.t, k0 + BN,
                             BN, t);
      cp_async_commit();
      cp_async_wait<1>();                     // this tile has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (k0 <= warp_last) {                    // else above the warp's diagonal

    // ---- S = Q K^T for 16 rows x BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    if constexpr (kScalar) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const float* qa = Qs + lr * LD;
        const float* qb2 = qa + 8 * LD;
        const float* ka = Ks + (n * 8 + 2 * tq) * LD;
        const float* kb2 = ka + LD;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          s[n][0] += qa[d] * ka[d];
          s[n][1] += qa[d] * kb2[d];
          s[n][2] += qb2[d] * ka[d];
          s[n][3] += qb2[d] * kb2[d];
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < BN / 8; n += 2) {
          // matrices 0, 1: keys n*8 + 0..7 at columns kk*16 + 0..7 and
          // 8..15; matrices 2, 3: the same columns of keys (n + 1)*8 + ..
          uint32_t kf[4];
          ldmatrix_x4(kf, Ks + ((n + (lane >> 4)) * 8 + (lane & 7)) * LD
                              + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[n], qf[kk], kf[0], kf[1]);
          mma_bf16(s[n + 1], qf[kk], kf[2], kf[3]);
        }
      }
    }

    // ---- mask, scale (to log2 units), running softmax. A tile behind
    // the pad, under the warp's first row and inside the sequence has no
    // masked key.
    const bool masked = (k0 < p) || (k0 + BN - 1 > warp_first)
                        || (k0 + BN > t);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (masked) {
          const int j = k0 + n * 8 + 2 * tq + (e & 1);
          const int i = (e < 2) ? row_a : row_b;
          ok = (j >= p) && (j <= i) && (j < t);
        }
        s[n][e] = ok ? s[n][e] * scale2 : -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no key yet keeps -inf; subtract 0 then, so that every
    // exponent is exp2(-inf) = 0 and never inf - inf
    const float mu_a = (mn_a == -INFINITY) ? 0.0f : mn_a;
    const float mu_b = (mn_b == -INFINITY) ? 0.0f : mn_b;
    const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mu_a);        // a masked key gives exactly 0
      s[n][1] = exp2f(s[n][1] - mu_a);
      s[n][2] = exp2f(s[n][2] - mu_b);
      s[n][3] = exp2f(s[n][3] - mu_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= al_a;
      o[d][1] *= al_a;
      o[d][2] *= al_b;
      o[d][3] *= al_b;
    }

    // ---- O += P V
    if constexpr (kScalar) {
      float* pw = Ps + warp * 16 * PS_LD;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        pw[g * PS_LD + n * 8 + 2 * tq] = s[n][0];
        pw[g * PS_LD + n * 8 + 2 * tq + 1] = s[n][1];
        pw[(g + 8) * PS_LD + n * 8 + 2 * tq] = s[n][2];
        pw[(g + 8) * PS_LD + n * 8 + 2 * tq + 1] = s[n][3];
      }
      __syncwarp();
      const float* pa = pw + g * PS_LD;
      const float* pb = pa + 8 * PS_LD;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const float* vp = Vs + d * 8 + 2 * tq;
#pragma unroll 8
        for (int j = 0; j < BN; ++j) {
          const float va = vp[j * LD], vb2 = vp[j * LD + 1];
          o[d][0] += pa[j] * va;
          o[d][1] += pa[j] * vb2;
          o[d][2] += pb[j] * va;
          o[d][3] += pb[j] * vb2;
        }
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pf[4];
        pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int d = 0; d < HD / 8; d += 2) {
          // matrices 0, 1: keys kk*16 + 0..7 and 8..15 at columns d*8;
          // matrices 2, 3: the same keys at columns (d + 1)*8
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vs + (kk * 16 + (lane & 7)
                                      + ((lane >> 3) & 1) * 8) * LD
                                    + (d + (lane >> 4)) * 8);
          mma_bf16(o[d], pf, vf[0], vf[1]);
          mma_bf16(o[d + 1], pf, vf[2], vf[3]);
        }
      }
    }
    }                                         // k0 <= warp_last
    __syncthreads();                          // the stage may be overwritten
  }

  // ---- epilogue: finish the row sums over the quad, normalise, store
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = (row_a >= p && l_a > 0.0f) ? 1.0f / l_a : 0.0f;
  const float inv_b = (row_b >= p && l_b > 0.0f) ? 1.0f / l_b : 0.0f;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = d * 8 + 2 * tq;
    if (row_a < t)
      store_pair<T>(ob + (long long)row_a * os.t + col, o[d][0] * inv_a,
                    o[d][1] * inv_a);
    if (row_b < t)
      store_pair<T>(ob + (long long)row_b * os.t + col, o[d][2] * inv_b,
                    o[d][3] * inv_b);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* pad,
           void* out, int b, int t, int heads, int rep, Strides qs,
           Strides ks, Strides vs, Strides os, float scale,
           cudaStream_t stream) {
  constexpr int LD = HD + RowPad<T>::v;
  size_t smem = (size_t)(BM + 4 * BN) * LD * sizeof(T);   // Q, 2 x (K, V)
  if (std::is_same<T, float>::value)
    smem += (size_t)NWARPS * 16 * PS_LD * sizeof(float);
  auto kernel = flash_prefill_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((t + BM - 1) / BM, heads, b);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pad, static_cast<T*>(out), t, rep, qs, ks, vs,
      os, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v,
             const int* pad, void* out, int b, int t, int heads, int rep,
             Strides qs, Strides ks, Strides vs, Strides os, float scale,
             cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, pad, out, b, t, heads, rep, qs, ks, vs,
                           os, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, pad, out, b, t, heads, rep, qs, ks, vs,
                            os, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (b, t, heads, hd); k, v: (b, >= t, kv_heads, hd), only the first
// t rows are read. strides: twelve element strides, (batch, token, head)
// of q, k, v, out; the last dimension is contiguous and every row starts
// on a 16-byte boundary. is_bf16: 1 for bf16 in and out, 0 for f32. hd is
// 64 or 128 (the sizes instantiated).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const int* pad, void* out, int b, int t,
                             int heads, int kv_heads, int hd, int is_bf16,
                             const long long* strides, float scale,
                             cudaStream_t stream) {
  if (b <= 0 || t <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const int rep = heads / kv_heads;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  if (is_bf16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, pad, out, b, t, heads, rep,
                                   qs, ks, vs, os, scale, stream);
  return dispatch<float>(hd, q, k, v, pad, out, b, t, heads, rep, qs, ks, vs,
                         os, scale, stream);
}
