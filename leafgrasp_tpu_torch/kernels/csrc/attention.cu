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
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

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
// Bound: bytes. At the training shape (16, 16, 256), spatial, the gradient
// reads x (262 KB) and the average pool's dy, N x C values stored (stride 0
// along HW), and writes dx: 0.54 MB, 0.00016 ms at 3.35 TB/s, far below
// one launch's own latency. So the design is about the chain of dependent
// steps and about launches, not bandwidth.
//
// One launch, one thread-block cluster: a block an example (examples
// rank, rank + cs, ... for a cluster of cs blocks, cs the largest power of
// two up to N and up to 16 where the card schedules 16, else 8). For each
// example a block
// 1. stages x and dy in shared memory with 16-byte loads in the order
//    they lie where their tile is contiguous in either layout (position-
//    major, or the CNN's NCHW activations seen as (N, HW, C)) and fits,
//    dy's C values where it has stride 0 along HW (the pool's gradient);
//    a tile past AG_STAGE floats is read through its strides instead;
// 2. recomputes s, m, a, g, then dz, du, da, dm (a warp a position, lanes
//    over channels; a thread a channel over positions; the C -> R and
//    R -> C mat-vecs as the forward does them);
// 3. writes dx in dx's own order and the example's record
//    [dws C | dbs 1 | m C | du C | h R | da R] (the parts of the modes it
//    runs) into global scratch.
// Then the cluster waits (barrier.cluster: release, acquire), and its
// blocks sum the records over n in order 0..N-1, a thread an output
// element of (dws, dbs, dW1, db1, dW2, db2); the parts of a mode left out
// are written as zeros. No float atomics and no state across calls: the
// gradient is the same bits from run to run (and for any cs), and two
// calls on two streams share nothing.

#define AGB_MAX_CLUSTER 16
#define AGB_BATCH 16                           // record loads in flight

struct GateGrad {
  const float* dy;
  long long dsn, dsp, dsc;
  const float* x;
  long long xsn, xsp, xsc;
  const float *ws, *bs, *w1, *b1, *w2, *b2;
  int N, HW, C, R, spatial, channel;
  float* dx;
  long long gsn, gsp, gsc;
  float* part;
  float* grads;
};

// an example's (HW, C) tile as the steps read it: t[p * pp + c * pc]
struct TileView {
  const float* t;
  long long pp, pc;
  __device__ __forceinline__ float operator()(int p, int c) const {
    return t[p * pp + c * pc];
  }
};

// the tile at g (strides sp, sc) staged in s (AG_STAGE floats) where it is
// contiguous in either layout and fits, or C values where sp is 0; else
// the tile as it lies. Loads are all issued before the first store.
__device__ __forceinline__ TileView stage_tile(float* s, const float* g,
                                               long long sp, long long sc,
                                               int HW, int C) {
  const int tid = threadIdx.x;
  if (sp == 0 || HW == 1) {                   // one value a channel
    for (int c = tid; c < C; c += AG_THREADS) s[c] = __ldg(g + c * sc);
    return {s, 0, 1};
  }
  const bool cmaj = sp == 1 && sc == HW;      // NCHW seen as (HW, C)
  if (!cmaj && !(sc == 1 && sp == C)) return {g, sp, sc};
  const int total = HW * C;
  const int spitch = cmaj ? (HW | 1) : C;     // odd: lanes over c differ
  if ((cmaj ? C * spitch : total) > AG_STAGE) return {g, sp, sc};
  const int inner = cmaj ? HW : C;            // the contiguous axis
  auto put = [&](int e, float v) {
    const int o = e / inner, i = e - o * inner;
    s[o * spitch + i] = v;
  };
  if ((inner & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    // four floats of a load share their row of the tile: one division
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4 keep[AG_KEEP];
#pragma unroll
    for (int k = 0; k < AG_KEEP; ++k) {
      const int f = tid + k * AG_THREADS;
      if (f < total / 4) keep[k] = __ldg(g4 + f);
    }
#pragma unroll
    for (int k = 0; k < AG_KEEP; ++k) {
      const int f = tid + k * AG_THREADS;
      if (f < total / 4) {
        const int o = 4 * f / inner, i = 4 * f - o * inner;
        float* d = s + o * spitch + i;
        d[0] = keep[k].x;
        d[1] = keep[k].y;
        d[2] = keep[k].z;
        d[3] = keep[k].w;
      }
    }
  } else {
    for (int e = tid; e < total; e += AG_THREADS) put(e, __ldg(g + e));
  }
  return cmaj ? TileView{s, 1, spitch} : TileView{s, spitch, 1};
}

// sum of term(i) over i = start, start + step, ... < n in four running
// sums (their loads in flight together), added in a fixed order
template <typename Term>
__device__ __forceinline__ float strided_sum(int n, int start, int step,
                                             Term term) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int i = start;
  for (; i + 3 * step < n; i += 4 * step) {
    s0 += term(i);
    s1 += term(i + step);
    s2 += term(i + 2 * step);
    s3 += term(i + 3 * step);
  }
  for (; i < n; i += step) s0 += term(i);
  return (s0 + s1) + (s2 + s3);
}

// sum over n = 0..N-1 of term(n), in that order; the loads of AGB_BATCH
// terms are issued before any is added (a record lives in L2: one round
// trip a batch, not one a term)
template <typename Term>
__device__ __forceinline__ float sum_over_n(int N, Term term) {
  float acc = 0.0f;
  for (int n0 = 0; n0 < N; n0 += AGB_BATCH) {
    float v[AGB_BATCH];
#pragma unroll
    for (int i = 0; i < AGB_BATCH; ++i)
      v[i] = n0 + i < N ? term(n0 + i) : 0.0f;
#pragma unroll
    for (int i = 0; i < AGB_BATCH; ++i)
      if (n0 + i < N) acc += v[i];
  }
  return acc;
}

__global__ void __launch_bounds__(AG_THREADS)
attention_gate_backward_kernel(const GateGrad a) {
  extern __shared__ float s_tile[];           // x, then dy: AG_STAGE each
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
  __shared__ float s_ws[AG_MAX_C];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HW = a.HW, C = a.C, R = a.R;
  const bool spatial = a.spatial, channel = a.channel;
  const float inv_hw = 1.0f / (float)HW;
  const int rec_len = 3 * C + 2 * R + 1;
  // values a channel (ws, and dy where it has stride 0 along HW) are
  // fetched into registers before x is staged, so that all the loads of
  // an example are in flight together
  constexpr int PER_C = AG_MAX_C / AG_THREADS;
  const bool dy_row = a.dsp == 0 || HW == 1;
  float ws_r[PER_C], dy_r[PER_C];
#pragma unroll
  for (int i = 0; i < PER_C; ++i) {
    const int c = tid + i * AG_THREADS;
    ws_r[i] = spatial && c < C ? __ldg(a.ws + c) : 0.0f;
  }

  for (int n = rank; n < a.N; n += cs) {
    if (n != rank) __syncthreads();           // the last example is read
    if (dy_row) {
#pragma unroll
      for (int i = 0; i < PER_C; ++i) {
        const int c = tid + i * AG_THREADS;
        dy_r[i] = c < C ? __ldg(a.dy + n * a.dsn + c * a.dsc) : 0.0f;
      }
    }
    const TileView X = stage_tile(s_tile, a.x + n * a.xsn, a.xsp, a.xsc,
                                  HW, C);
    TileView DY{s_tile + AG_STAGE, 0, 1};
    if (dy_row) {
#pragma unroll
      for (int i = 0; i < PER_C; ++i) {
        const int c = tid + i * AG_THREADS;
        if (c < C) s_tile[AG_STAGE + c] = dy_r[i];
      }
    } else {
      DY = stage_tile(s_tile + AG_STAGE, a.dy + n * a.dsn, a.dsp, a.dsc, HW,
                      C);
    }
    if (n == rank) {
#pragma unroll
      for (int i = 0; i < PER_C; ++i) {
        const int c = tid + i * AG_THREADS;
        if (c < C) s_ws[c] = ws_r[i];
      }
    }
    __syncthreads();

    // the forward's gates, recomputed
    for (int p = warp; p < HW; p += AG_WARPS) {
      float z = spatial ? strided_sum(C, lane, 32, [&](int c) {
        return X(p, c) * s_ws[c];
      }) : 0.0f;
      z = ag_warp_sum(z);
      if (lane == 0) s_s[p] = spatial ? ag_sigmoid(z + a.bs[0]) : 1.0f;
    }
    if (channel) {
      for (int c = tid; c < C; c += AG_THREADS)
        s_m[c] = strided_sum(HW, 0, 1, [&](int p) { return X(p, c); })
                 * inv_hw;
      __syncthreads();
      const int S = AG_THREADS / R;
      {
        const int j = tid % R, sl = tid / R;
        float acc = 0.0f;
        if (sl < S)
          for (int c = sl; c < C; c += S) acc += s_m[c] * a.w1[c * R + j];
        s_part[tid] = acc;
      }
      __syncthreads();
      for (int j = warp; j < R; j += AG_WARPS) {
        float acc = 0.0f;
        for (int sl = lane; sl < S; sl += 32) acc += s_part[sl * R + j];
        acc = ag_warp_sum(acc);
        if (lane == 0) {
          s_a[j] = acc + a.b1[j];
          s_h[j] = fmaxf(acc + a.b1[j], 0.0f);
        }
      }
      __syncthreads();
    }
    for (int c = tid; c < C; c += AG_THREADS) {
      float u = 0.0f;
      if (channel) {
        for (int j = 0; j < R; ++j) u += s_h[j] * a.w2[j * C + c];
        s_g[c] = ag_sigmoid(u + a.b2[c]);
      } else {
        s_g[c] = 1.0f;
      }
    }
    __syncthreads();

    // dz: a warp a position, lanes over channels
    if (spatial) {
      for (int p = warp; p < HW; p += AG_WARPS) {
        float d = strided_sum(C, lane, 32, [&](int c) {
          return DY(p, c) * X(p, c) * s_g[c];
        });
        d = ag_warp_sum(d);
        if (lane == 0) s_dz[p] = d * (s_s[p] * (1.0f - s_s[p]));
      }
    } else {
      for (int p = tid; p < HW; p += AG_THREADS) s_dz[p] = 0.0f;
    }
    // du: a thread a channel
    for (int c = tid; c < C; c += AG_THREADS) {
      const float d = channel ? strided_sum(HW, 0, 1, [&](int p) {
        return DY(p, c) * X(p, c) * s_s[p];
      }) : 0.0f;
      s_du[c] = channel ? d * (s_g[c] * (1.0f - s_g[c])) : 0.0f;
    }
    __syncthreads();
    // da: a warp a hidden unit, lanes over channels (W2's row j coalesced)
    if (channel) {
      for (int j = warp; j < R; j += AG_WARPS) {
        float d = 0.0f;
        for (int c = lane; c < C; c += 32) d += s_du[c] * a.w2[j * C + c];
        d = ag_warp_sum(d);
        if (lane == 0) s_da[j] = s_a[j] > 0.0f ? d : 0.0f;
      }
      __syncthreads();
      for (int c = tid; c < C; c += AG_THREADS) {
        float d = 0.0f;
        for (int j = 0; j < R; ++j) d += s_da[j] * a.w1[c * R + j];
        s_dm[c] = d;
      }
      __syncthreads();
    }

    // dx, in dx's own order: neighbouring threads on neighbouring
    // addresses, 16 bytes a thread where dx is contiguous in either layout
    float* dxn = a.dx + n * a.gsn;
    auto dx_at = [&](int p, int c) {
      float v = DY(p, c) * s_s[p] * s_g[c];
      if (spatial) v += s_dz[p] * s_ws[c];
      if (channel) v += s_dm[c] * inv_hw;
      return v;
    };
    const bool cfast = a.gsc <= a.gsp;
    const int inner = cfast ? C : HW;
    const bool dense = cfast ? (a.gsc == 1 && a.gsp == C)
                             : (a.gsp == 1 && a.gsc == HW);
    if (dense && (inner & 3) == 0
        && (reinterpret_cast<uintptr_t>(dxn) & 15) == 0) {
      for (int f = tid; f < HW * C / 4; f += AG_THREADS) {
        const int o = 4 * f / inner, i = 4 * f - o * inner;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = cfast ? dx_at(o, i + k) : dx_at(i + k, o);
        reinterpret_cast<float4*>(dxn)[f] = make_float4(v[0], v[1], v[2],
                                                        v[3]);
      }
    } else {
      for (int e = tid; e < HW * C; e += AG_THREADS) {
        const int p = cfast ? e / C : e % HW;
        const int c = cfast ? e % C : e / HW;
        dxn[p * a.gsp + c * a.gsc] = dx_at(p, c);
      }
    }

    // the example's record for the sum over n: the parts its modes need
    float* rec = a.part + (long long)n * rec_len;
    for (int c = tid; c < C; c += AG_THREADS) {
      if (spatial)
        rec[c] = strided_sum(HW, 0, 1,
                             [&](int p) { return s_dz[p] * X(p, c); });
      if (channel) {
        rec[C + 1 + c] = s_m[c];
        rec[2 * C + 1 + c] = s_du[c];
      }
    }
    if (channel)
      for (int j = tid; j < R; j += AG_THREADS) {
        rec[3 * C + 1 + j] = s_h[j];
        rec[3 * C + 1 + R + j] = s_da[j];
      }
    if (spatial && warp == 0) {               // dbs: lanes over positions
      float d = 0.0f;
      for (int p = lane; p < HW; p += 32) d += s_dz[p];
      d = ag_warp_sum(d);
      if (lane == 0) rec[C] = d;
    }
  }

  // every record is written; the cluster sums them. The barrier's arrive
  // releases and its wait acquires at the cluster's scope, so the records
  // (read from L2 below) are visible without a fence
  cluster.sync();
  // grads = [dws C | dbs 1 | dW1 C*R | db1 R | dW2 R*C | db2 C], each the
  // sum over n = 0..N-1 of the records, in that order; read from L2
  const int total = 2 * C + 1 + 2 * C * R + R;
  const int m_off = C + 1, du_off = 2 * C + 1, h_off = 3 * C + 1,
            da_off = 3 * C + 1 + R;
  const float* part = a.part;
  auto rec = [&](int n) { return part + (long long)n * rec_len; };
  for (int k = rank * AG_THREADS + tid; k < total; k += cs * AG_THREADS) {
    int o = k;
    float acc = 0.0f;
    if (o < C + 1) {                                   // dws, dbs
      if (spatial)
        acc = sum_over_n(a.N, [&](int n) { return __ldcg(rec(n) + o); });
    } else if (!channel) {                             // dW1 .. db2: zeros
    } else if ((o -= C + 1) < C * R) {                 // dW1[c, j]
      const int c = o / R, j = o % R;
      acc = sum_over_n(a.N, [&](int n) {
        return __ldcg(rec(n) + m_off + c) * __ldcg(rec(n) + da_off + j);
      });
    } else if ((o -= C * R) < R) {                     // db1[j]
      acc = sum_over_n(a.N,
                       [&](int n) { return __ldcg(rec(n) + da_off + o); });
    } else if ((o -= R) < R * C) {                     // dW2[j, c]
      const int j = o / C, c = o % C;
      acc = sum_over_n(a.N, [&](int n) {
        return __ldcg(rec(n) + h_off + j) * __ldcg(rec(n) + du_off + c);
      });
    } else {                                           // db2[c]
      o -= R * C;
      acc = sum_over_n(a.N,
                       [&](int n) { return __ldcg(rec(n) + du_off + o); });
    }
    a.grads[k] = acc;
  }
}

// the cluster size for N examples: the largest power of two up to N and
// up to 16 blocks where the card schedules a cluster of 16 of these
// blocks, else up to 8 (the portable size)
static int gate_grad_cluster(int N, size_t smem, cudaStream_t stream) {
  static int max_cs = 0;
  if (max_cs == 0) {
    max_cs = 8;
    auto kernel = attention_gate_backward_kernel;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(AGB_MAX_CLUSTER);
      cfg.blockDim = dim3(AG_THREADS);
      cfg.dynamicSmemBytes = smem;
      cfg.stream = stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = AGB_MAX_CLUSTER;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) ==
              cudaSuccess && clusters > 0)
        max_cs = AGB_MAX_CLUSTER;
    }
    (void)cudaGetLastError();                 // a refused query: 8
  }
  int cs = 1;
  while (cs * 2 <= N && cs * 2 <= max_cs) cs *= 2;
  return cs;
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
  const size_t smem = 2 * AG_STAGE * sizeof(float);
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_gate_backward_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int cs = gate_grad_cluster(N, smem, stream);
  const GateGrad a{dy, dsn, dsp, dsc, x, xsn, xsp, xsc, ws, bs, w1, b1, w2,
                   b2, N, HW, C, R, spatial, channel, dx, gsn, gsp, gsc,
                   part, grads};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(AG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, attention_gate_backward_kernel, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
