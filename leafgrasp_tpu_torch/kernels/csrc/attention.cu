// Fused attention gate of GraspPointCNN for Hopper:
//   out[n, p, c] = x[n, p, c] * sigmoid(x[n, p, :] . ws + bs)          (spatial)
//                             * sigmoid(relu(mean_p x[n] . w1 + b1) . w2 + b2)[c]
//                                                                      (channel)
// Replaces leafgrasp_tpu/models/attention_pallas.py fused_attention_gate
// / _kernel (:63 / :42).
//
// Bound: bytes. The gate reads x once and writes it once (2 x N*HW*C*4
// bytes, 655 KB at the main path's (20, 16, 256)) and does ~6 operations
// per element; at that size a launch's own latency, not either roofline,
// sets the time, so the design keeps the chain of dependent steps short.
//
// x arrives in one of two layouts, a template flag: position-major
// (N, HW, C) as it lies, or channel-major, the CNN's NCHW activations
// seen as (N, HW, C) through their strides (the wrapper passes them as
// they are, no copy). out has the layout of x.
//
// Design: one block of AG_THREADS threads an example.
// 1. The example's HW x C tile is contiguous in either layout. Each
//    thread loads its share with 16-byte loads, all issued before any is
//    used, keeps them in registers for the output and stores them into
//    shared memory (a channel-major tile with an odd row pitch, so that
//    lanes over channels hit distinct banks). A tile past AG_STAGE floats
//    (the kernel's limits allow 64 x 1024) is read from global memory in
//    each step instead.
// 2. One barrier, then every position's dot with ws at once, a warp a
//    position, lanes over channels, a shuffle reduction; the channel means
//    a thread a channel.
// 3. Squeeze-excite (channel, hybrid): the C -> R mat-vec as R partial
//    sums over channel slices (threads adjacent in R read w1 coalesced),
//    finished by a warp reduction a hidden unit; R -> C a thread a channel
//    (w2 read coalesced).
// 4. The output from registers, multiplied and stored 16 bytes a lane.
// The file is built with -fmad=false; sums may differ from the plain
// version's order by rounding (tolerance 1e-5).

#include <cuda_runtime.h>
#include <math.h>

#define AG_MAX_HW 64
#define AG_MAX_C 1024
#define AG_MAX_R 64
#define AG_THREADS 256
#define AG_WARPS (AG_THREADS / 32)
#define AG_STAGE 9216                          // floats of a staged tile
#define AG_KEEP (AG_STAGE / 4 / AG_THREADS)    // float4 a thread keeps

__device__ __forceinline__ float ag_sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float ag_warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool CMAJOR>
__global__ void __launch_bounds__(AG_THREADS)
fused_attention_gate_kernel(
    const float* __restrict__ x, const float* __restrict__ ws,
    const float* __restrict__ bs, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, int HW, int C, int R, int spatial,
    int channel, int vec, float* __restrict__ out) {
  extern __shared__ float sx[];                // the staged tile
  __shared__ float sp[AG_MAX_HW];
  __shared__ float mean[AG_MAX_C];
  __shared__ float gate[AG_MAX_C];
  __shared__ float part[AG_THREADS];
  __shared__ float hidden[AG_MAX_R];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = HW * C;
  const size_t base = (size_t)blockIdx.x * total;
  // element e of the tile, in the order x lies, at (p, c)
  auto pos_of = [&](int e) { return CMAJOR ? e % HW : e / C; };
  auto chan_of = [&](int e) { return CMAJOR ? e / HW : e % C; };
  const int spitch = CMAJOR ? (HW | 1) : C;    // pitch of the staged tile
  const bool staged = (CMAJOR ? C * spitch : total) <= AG_STAGE;
  auto sidx = [&](int p, int c) {
    return CMAJOR ? c * spitch + p : p * spitch + c;
  };

  float4 keep[AG_KEEP];
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  if (staged) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < AG_KEEP; ++k) {
        const int f = tid + k * AG_THREADS;
        if (f < total / 4) keep[k] = __ldg(x4 + f);
      }
#pragma unroll
      for (int k = 0; k < AG_KEEP; ++k) {
        const int f = tid + k * AG_THREADS;
        if (f < total / 4) {
          const float v[4] = {keep[k].x, keep[k].y, keep[k].z, keep[k].w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sx[sidx(pos_of(4 * f + i), chan_of(4 * f + i))] = v[i];
        }
      }
    } else {
      for (int e = tid; e < total; e += AG_THREADS)
        sx[sidx(pos_of(e), chan_of(e))] = __ldg(x + base + e);
    }
    __syncthreads();
  }
  // the tile as the steps below read it: staged, or as it lies
  const float* t = staged ? sx : x + base;
  const int pitch = staged ? spitch : (CMAJOR ? HW : C);
  auto at = [&](int p, int c) {
    return t[CMAJOR ? c * pitch + p : p * pitch + c];
  };

  if (spatial) {
    for (int p = warp; p < HW; p += AG_WARPS) {
      float s = 0.0f;
      for (int c = lane; c < C; c += 32) s += at(p, c) * ws[c];
      s = ag_warp_sum(s);
      if (lane == 0) sp[p] = ag_sigmoid(s + bs[0]);
    }
  }
  if (channel) {
    const float inv_hw = 1.0f / (float)HW;
    for (int c = tid; c < C; c += AG_THREADS) {
      float s = 0.0f;
      for (int p = 0; p < HW; ++p) s += at(p, c);
      mean[c] = s * inv_hw;
    }
    __syncthreads();
    // hidden[j] = relu(b1[j] + sum_c mean[c] w1[c, j]): thread (s, j) sums
    // the channels c = s, s + S, ...; a warp then adds the S slices of j
    const int S = AG_THREADS / R;
    {
      const int j = tid % R, s = tid / R;
      float a = 0.0f;
      if (s < S)
        for (int c = s; c < C; c += S) a += mean[c] * w1[c * R + j];
      part[tid] = a;
    }
    __syncthreads();
    for (int j = warp; j < R; j += AG_WARPS) {
      float a = 0.0f;
      for (int s = lane; s < S; s += 32) a += part[s * R + j];
      a = ag_warp_sum(a);
      if (lane == 0) hidden[j] = fmaxf(a + b1[j], 0.0f);
    }
    __syncthreads();
    for (int c = tid; c < C; c += AG_THREADS) {
      float a = 0.0f;
      for (int j = 0; j < R; ++j) a += hidden[j] * w2[j * C + c];
      gate[c] = ag_sigmoid(a + b2[c]);
    }
  }
  __syncthreads();

  auto scale = [&](int e, float v) {
    if (spatial) v = v * sp[pos_of(e)];
    if (channel) v = v * gate[chan_of(e)];
    return v;
  };
  float* on = out + base;
  if (vec) {
    float4* o4 = reinterpret_cast<float4*>(on);
    auto emit = [&](int f, float4 v) {
      v.x = scale(4 * f, v.x);
      v.y = scale(4 * f + 1, v.y);
      v.z = scale(4 * f + 2, v.z);
      v.w = scale(4 * f + 3, v.w);
      o4[f] = v;
    };
    if (staged) {
#pragma unroll
      for (int k = 0; k < AG_KEEP; ++k) {
        const int f = tid + k * AG_THREADS;
        if (f < total / 4) emit(f, keep[k]);
      }
    } else {
      for (int f = tid; f < total / 4; f += AG_THREADS) emit(f, __ldg(x4 + f));
    }
  } else {
    for (int e = tid; e < total; e += AG_THREADS)
      on[e] = scale(e, staged ? sx[sidx(pos_of(e), chan_of(e))]
                              : __ldg(x + base + e));
  }
}

// x and out (N, HW, C): position-major (cmajor = 0, strides (HW*C, C, 1))
// or channel-major (cmajor = 1, strides (HW*C, 1, HW)); vec: 16-byte
// access (the contiguous axis a multiple of 4, x and out 16-byte aligned).
extern "C" int fused_attention_gate(const float* x, const float* ws,
                                    const float* bs, const float* w1,
                                    const float* b1, const float* w2,
                                    const float* b2, int N, int HW, int C,
                                    int R, int spatial, int channel,
                                    int cmajor, int vec, float* out,
                                    cudaStream_t stream) {
  if (N <= 0) return 0;
  if (HW <= 0 || C <= 0 || R <= 0 || HW > AG_MAX_HW || C > AG_MAX_C ||
      R > AG_MAX_R)
    return (int)cudaErrorInvalidValue;
  const int floats = cmajor ? C * (HW | 1) : HW * C;
  const size_t smem = floats <= AG_STAGE ? floats * sizeof(float) : 0;
  if (cmajor)
    fused_attention_gate_kernel<true><<<N, AG_THREADS, smem, stream>>>(
        x, ws, bs, w1, b1, w2, b2, HW, C, R, spatial, channel, vec, out);
  else
    fused_attention_gate_kernel<false><<<N, AG_THREADS, smem, stream>>>(
        x, ws, bs, w1, b1, w2, b2, HW, C, R, spatial, channel, vec, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The gate's gradient. XLA's autodiff of the plain gate
// (leafgrasp_tpu/models/attention_pallas.py:26-39 attention_gate_reference)
// is what the JAX package trains through; the Pallas kernel has no backward.
// With s = sigmoid(x . ws + bs) per position (1 without the spatial gate),
// g = sigmoid(relu(a) . W2 + b2) per channel, a = mean_p(x) . W1 + b1
// (1 without the channel gate) and y = x s g:
//   dz[p]  = s (1 - s) sum_c dy x g                        (spatial)
//   du[c]  = g (1 - g) sum_p dy x s                        (channel)
//   da[j]  = [a > 0] sum_c du[c] W2[j, c]
//   dm[c]  = sum_j da[j] W1[c, j]
//   dx     = dy s g + dz ws + dm / HW
//   dws[c] = sum_{n,p} dz x;  dbs = sum_{n,p} dz
//   dW2[j, c] = sum_n h[j] du[c];  db2 = sum_n du
//   dW1[c, j] = sum_n m[c] da[j];  db1 = sum_n da
//
// Bound: at the training shape (16, 16, 256) the gradient reads x and dy
// and writes dx (~0.8 MB): below one launch's latency, so the design is
// the simple one. Two launches:
// 1. one block an example recomputes s, m, a, g, then dz, du, da, dm in
//    shared memory, writes dx and the example's record
//    [dws C | dbs 1 | m C | du C | h R | da R] into scratch;
// 2. a thread an output element of (dws, dbs, dW1, db1, dW2, db2) sums the
//    records over n in order 0..N-1.
// No float atomics: the gradient is the same bits from run to run. x, dy
// and dx are read and written through their strides: dy arrives from the
// global average pool as an expanded tensor with stride 0 along HW.

#define AGB_REDUCE_THREADS 256

__global__ void __launch_bounds__(AG_THREADS)
attention_gate_backward_kernel(
    const float* __restrict__ dy, long long dsn, long long dsp, long long dsc,
    const float* __restrict__ x, long long xsn, long long xsp, long long xsc,
    const float* __restrict__ ws, const float* __restrict__ bs,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, int HW,
    int C, int R, int spatial, int channel, float* __restrict__ dx,
    long long gsn, long long gsp, long long gsc, float* __restrict__ part) {
  __shared__ float s_s[AG_MAX_HW];
  __shared__ float s_dz[AG_MAX_HW];
  __shared__ float s_m[AG_MAX_C];
  __shared__ float s_g[AG_MAX_C];
  __shared__ float s_du[AG_MAX_C];
  __shared__ float s_dm[AG_MAX_C];
  __shared__ float s_part[AG_THREADS];
  __shared__ float s_a[AG_MAX_R];
  __shared__ float s_h[AG_MAX_R];
  __shared__ float s_da[AG_MAX_R];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x;
  const float* xn = x + (long long)n * xsn;
  const float* dyn = dy + (long long)n * dsn;
  float* dxn = dx + (long long)n * gsn;
  auto X = [&](int p, int c) { return __ldg(xn + p * xsp + c * xsc); };
  auto DY = [&](int p, int c) { return __ldg(dyn + p * dsp + c * dsc); };
  const float inv_hw = 1.0f / (float)HW;

  // the forward's gates, recomputed
  for (int p = warp; p < HW; p += AG_WARPS) {
    float z = 0.0f;
    if (spatial)
      for (int c = lane; c < C; c += 32) z += X(p, c) * ws[c];
    z = ag_warp_sum(z);
    if (lane == 0) s_s[p] = spatial ? ag_sigmoid(z + bs[0]) : 1.0f;
  }
  for (int c = tid; c < C; c += AG_THREADS) {
    float a = 0.0f;
    if (channel)
      for (int p = 0; p < HW; ++p) a += X(p, c);
    s_m[c] = a * inv_hw;
  }
  __syncthreads();
  if (channel) {
    const int S = AG_THREADS / R;
    {
      const int j = tid % R, sl = tid / R;
      float a = 0.0f;
      if (sl < S)
        for (int c = sl; c < C; c += S) a += s_m[c] * w1[c * R + j];
      s_part[tid] = a;
    }
    __syncthreads();
    for (int j = warp; j < R; j += AG_WARPS) {
      float a = 0.0f;
      for (int sl = lane; sl < S; sl += 32) a += s_part[sl * R + j];
      a = ag_warp_sum(a);
      if (lane == 0) {
        s_a[j] = a + b1[j];
        s_h[j] = fmaxf(a + b1[j], 0.0f);
      }
    }
    __syncthreads();
  }
  for (int c = tid; c < C; c += AG_THREADS) {
    float u = 0.0f;
    if (channel) {
      for (int j = 0; j < R; ++j) u += s_h[j] * w2[j * C + c];
      s_g[c] = ag_sigmoid(u + b2[c]);
    } else {
      s_g[c] = 1.0f;
    }
  }
  __syncthreads();

  // dz: a warp a position, lanes over channels
  for (int p = warp; p < HW; p += AG_WARPS) {
    float d = 0.0f;
    if (spatial)
      for (int c = lane; c < C; c += 32) d += DY(p, c) * X(p, c) * s_g[c];
    d = ag_warp_sum(d);
    if (lane == 0) s_dz[p] = spatial ? d * (s_s[p] * (1.0f - s_s[p])) : 0.0f;
  }
  // du: a thread a channel
  for (int c = tid; c < C; c += AG_THREADS) {
    float d = 0.0f;
    if (channel)
      for (int p = 0; p < HW; ++p) d += DY(p, c) * X(p, c) * s_s[p];
    s_du[c] = channel ? d * (s_g[c] * (1.0f - s_g[c])) : 0.0f;
  }
  __syncthreads();
  // da: a warp a hidden unit, lanes over channels (W2's row j coalesced)
  if (channel) {
    for (int j = warp; j < R; j += AG_WARPS) {
      float d = 0.0f;
      for (int c = lane; c < C; c += 32) d += s_du[c] * w2[j * C + c];
      d = ag_warp_sum(d);
      if (lane == 0) s_da[j] = s_a[j] > 0.0f ? d : 0.0f;
    }
    __syncthreads();
  }
  for (int c = tid; c < C; c += AG_THREADS) {
    float d = 0.0f;
    if (channel)
      for (int j = 0; j < R; ++j) d += s_da[j] * w1[c * R + j];
    s_dm[c] = d;
  }
  __syncthreads();

  // dx, in dx's own order: neighbouring threads on neighbouring addresses
  const bool cfast = gsc <= gsp;
  for (int e = tid; e < HW * C; e += AG_THREADS) {
    const int p = cfast ? e / C : e % HW;
    const int c = cfast ? e % C : e / HW;
    float v = DY(p, c) * s_s[p] * s_g[c];
    if (spatial) v += s_dz[p] * ws[c];
    if (channel) v += s_dm[c] * inv_hw;
    dxn[p * gsp + c * gsc] = v;
  }

  // the example's record for the reduction over n
  float* rec = part + (long long)n * (3 * C + 2 * R + 1);
  for (int c = tid; c < C; c += AG_THREADS) {
    float d = 0.0f;
    if (spatial)
      for (int p = 0; p < HW; ++p) d += s_dz[p] * X(p, c);
    rec[c] = d;
    rec[C + 1 + c] = s_m[c];
    rec[2 * C + 1 + c] = s_du[c];
  }
  for (int j = tid; j < R; j += AG_THREADS) {
    rec[3 * C + 1 + j] = channel ? s_h[j] : 0.0f;
    rec[3 * C + 1 + R + j] = channel ? s_da[j] : 0.0f;
  }
  if (tid == 0) {
    float d = 0.0f;
    for (int p = 0; p < HW; ++p) d += s_dz[p];
    rec[C] = d;
  }
}

// grads = [dws C | dbs 1 | dW1 C*R | db1 R | dW2 R*C | db2 C], each the
// sum over n = 0..N-1 of the records, in that order
__global__ void __launch_bounds__(AGB_REDUCE_THREADS)
attention_gate_grad_reduce_kernel(const float* __restrict__ part, int N,
                                  int C, int R, float* __restrict__ grads) {
  const int rec = 3 * C + 2 * R + 1;
  const int total = 2 * C + 1 + 2 * C * R + R;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  const int m_off = C + 1, du_off = 2 * C + 1, h_off = 3 * C + 1,
            da_off = 3 * C + 1 + R;
  int o = k;
  float acc = 0.0f;
  if (o < C + 1) {                                   // dws, dbs
    for (int n = 0; n < N; ++n) acc += part[(long long)n * rec + o];
  } else if ((o -= C + 1) < C * R) {                 // dW1[c, j]
    const int c = o / R, j = o % R;
    for (int n = 0; n < N; ++n) {
      const float* r = part + (long long)n * rec;
      acc += r[m_off + c] * r[da_off + j];
    }
  } else if ((o -= C * R) < R) {                     // db1[j]
    for (int n = 0; n < N; ++n) acc += part[(long long)n * rec + da_off + o];
  } else if ((o -= R) < R * C) {                     // dW2[j, c]
    const int j = o / C, c = o % C;
    for (int n = 0; n < N; ++n) {
      const float* r = part + (long long)n * rec;
      acc += r[h_off + j] * r[du_off + c];
    }
  } else {                                           // db2[c]
    o -= R * C;
    for (int n = 0; n < N; ++n) acc += part[(long long)n * rec + du_off + o];
  }
  grads[k] = acc;
}

// dy, x and dx (N, HW, C) with element strides (sn, sp, sc) each; part
// scratch of N * (3C + 2R + 1) floats; grads 2C + 1 + 2CR + R floats.
extern "C" int attention_gate_backward(
    const float* dy, long long dsn, long long dsp, long long dsc,
    const float* x, long long xsn, long long xsp, long long xsc,
    const float* ws, const float* bs, const float* w1, const float* b1,
    const float* w2, const float* b2, int N, int HW, int C, int R,
    int spatial, int channel, float* dx, long long gsn, long long gsp,
    long long gsc, float* part, float* grads, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (HW <= 0 || C <= 0 || R <= 0 || HW > AG_MAX_HW || C > AG_MAX_C ||
      R > AG_MAX_R)
    return (int)cudaErrorInvalidValue;
  attention_gate_backward_kernel<<<N, AG_THREADS, 0, stream>>>(
      dy, dsn, dsp, dsc, x, xsn, xsp, xsc, ws, bs, w1, b1, w2, b2, HW, C, R,
      spatial, channel, dx, gsn, gsp, gsc, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = 2 * C + 1 + 2 * C * R + R;
  attention_gate_grad_reduce_kernel<<<
      (total + AGB_REDUCE_THREADS - 1) / AGB_REDUCE_THREADS,
      AGB_REDUCE_THREADS, 0, stream>>>(part, N, C, R, grads);
  return (int)cudaGetLastError();
}
