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
