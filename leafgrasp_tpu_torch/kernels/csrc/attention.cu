// Fused attention gate of GraspPointCNN for Hopper:
//   out[n, p, c] = x[n, p, c] * sigmoid(x[n, p, :] . ws + bs)          (spatial)
//                             * sigmoid(relu(mean_p x[n] . w1 + b1) . w2 + b2)[c]
//                                                                      (channel)
// Replaces leafgrasp_tpu/models/attention_pallas.py fused_attention_gate
// / _kernel (:63 / :42).
//
// Bound: bytes. The gate reads x once and writes it once (2 x N*HW*C*4
// bytes, 655 KB at the main path's (20, 16, 256)) and does ~6 operations
// per element; at that size launch latency, not either roofline, sets
// the time. Design: one block per example with one thread per channel
// (x rows are read coalesced across threads); the spatial dot is a
// block reduction per position (warp shuffles, then shared memory), the
// channel mean is a per-thread loop over positions into shared memory,
// the two small mat-vecs (C -> R -> C) run in the block from shared
// memory, and one multiply pass writes the output. Nothing but x and
// out touches device memory in bulk.

#include <cuda_runtime.h>
#include <math.h>

#define AG_MAX_HW 64
#define AG_MAX_C 1024
#define AG_MAX_R 64

__device__ __forceinline__ float ag_sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__global__ void fused_attention_gate_kernel(
    const float* __restrict__ x, const float* __restrict__ ws,
    const float* __restrict__ bs, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, int HW, int C, int R, int spatial,
    int channel, float* __restrict__ out) {
  __shared__ float sp[AG_MAX_HW];
  __shared__ float warp_part[32];
  __shared__ float squeezed[AG_MAX_C];
  __shared__ float hidden[AG_MAX_R];
  __shared__ float gate[AG_MAX_C];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  const float* xn = x + (size_t)n * HW * C;
  float* on = out + (size_t)n * HW * C;

  if (spatial) {
    for (int p = 0; p < HW; ++p) {
      float part = 0.0f;
      for (int c = tid; c < C; c += blockDim.x) part += xn[p * C + c] * ws[c];
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_down_sync(0xffffffffu, part, off);
      if (lane == 0) warp_part[warp] = part;
      __syncthreads();
      if (tid == 0) {
        float s = 0.0f;
        for (int w = 0; w < n_warps; ++w) s += warp_part[w];
        sp[p] = ag_sigmoid(s + bs[0]);
      }
      __syncthreads();
    }
  }

  if (channel) {
    const float inv_hw = 1.0f / (float)HW;
    for (int c = tid; c < C; c += blockDim.x) {
      float s = 0.0f;
      for (int p = 0; p < HW; ++p) s += xn[p * C + c];
      squeezed[c] = s * inv_hw;
    }
    __syncthreads();
    for (int j = tid; j < R; j += blockDim.x) {
      float s = 0.0f;
      for (int c = 0; c < C; ++c) s += squeezed[c] * w1[c * R + j];
      hidden[j] = fmaxf(s + b1[j], 0.0f);
    }
    __syncthreads();
    for (int c = tid; c < C; c += blockDim.x) {
      float s = 0.0f;
      for (int j = 0; j < R; ++j) s += hidden[j] * w2[j * C + c];
      gate[c] = ag_sigmoid(s + b2[c]);
    }
    __syncthreads();
  }

  for (int p = 0; p < HW; ++p) {
    for (int c = tid; c < C; c += blockDim.x) {
      float v = xn[p * C + c];
      if (spatial) v = v * sp[p];
      if (channel) v = v * gate[c];
      on[p * C + c] = v;
    }
  }
}

extern "C" int fused_attention_gate(const float* x, const float* ws,
                                    const float* bs, const float* w1,
                                    const float* b1, const float* w2,
                                    const float* b2, int N, int HW, int C,
                                    int R, int spatial, int channel,
                                    float* out, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (HW > AG_MAX_HW || C > AG_MAX_C || R > AG_MAX_R)
    return (int)cudaErrorInvalidValue;
  int threads = ((C + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  fused_attention_gate_kernel<<<N, threads, 0, stream>>>(
      x, ws, bs, w1, b1, w2, b2, HW, C, R, spatial, channel, out);
  return (int)cudaGetLastError();
}
