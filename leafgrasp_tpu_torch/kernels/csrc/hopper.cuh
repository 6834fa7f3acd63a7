// Hopper building blocks as inline PTX, for the kernels of this directory
// that use the asynchronous units of sm_90a: mbarriers, tiled TMA loads
// (and the host side that encodes their tensor maps), and warpgroup
// matrix multiply-accumulate (wgmma) on bf16 with f32 accumulators; then
// the products of f32 operands written as bf16 planes, which the f32
// flash kernels (flash_prefill.cu, flash_prefill_bwd.cu) share. Nothing
// here is a kernel.
//
// Shared-memory operand tiles are rows of 128 bytes (64 bf16) in the
// 128-byte swizzle, eight rows (1024 bytes) a swizzle atom, as a TMA load
// with CU_TENSOR_MAP_SWIZZLE_128B writes them; a tile starts on a
// 1024-byte boundary.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the asynchronous proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// spins until the phase of the given parity has completed; a phase that
// never completes (a wrong parity or byte count) ends the kernel with an
// error after 2^24 tries, instead of a card that spins for ever
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == (1u << 24)) __trap();
  }
}

// ---- TMA --------------------------------------------------------------------

// one box of a rank-4 tensor map into shared memory; completion is
// counted in bytes on `bar`. Coordinates innermost first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// orders this thread's earlier shared-memory accesses of the generic proxy
// (ordinary loads and stores) before later accesses of the asynchronous
// proxy (wgmma operand reads, TMA writes); a barrier then publishes them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled lives in libcuda and the kernel library links
// against the runtime only: take it from the libcuda.so.1 that the
// process has loaded already.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiledFn>(
        dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// rank-4 map of a (batch, token, head, hd) tensor of `elem` bytes an
// element (strides sb, st, sh in elements) read as boxes of `rows` tokens
// x `cols` elements of one head; `tokens` bounds the token dimension, so
// rows beyond it are zero-filled and never read
inline bool make_map_4d(CUtensorMap* map, CUtensorMapDataType type,
                        int elem, const void* ptr, int hd, int tokens,
                        int n_heads, int b, long long sb, long long st,
                        long long sh, int cols, int rows,
                        CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row_bytes = (cuuint64_t)hd * elem;
  auto stride = [&](int size, long long elems) {      // of a size-1 dim: any
    return size > 1 ? (cuuint64_t)elems * elem : row_bytes;
  };
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)tokens,
                              (cuuint64_t)n_heads, (cuuint64_t)b};
  const cuuint64_t strides[3] = {stride(tokens, st), stride(n_heads, sh),
                                 stride(b, sb)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operand
// (the reduction dimension contiguous: rows of 64 elements): sbo is the
// distance between groups of eight rows (1024), lbo is not used. MN-major
// operand (the non-reduction dimension contiguous, the transpose bit of
// the instruction set): lbo is the distance between 64-element column
// blocks, sbo between groups of eight reduction rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The accumulators of an asynchronous wgmma are written behind the
// compiler's back: this pins every use of them after the wait (or every
// write before the issue) to its side of the asm statement.
template <int N> __device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int REGS> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// D (64 x N, f32, registers) = or += A (64 x 16) . B (16 x N), bf16.
// _ss: A and B through shared-memory descriptors, both K-major (N = 128,
// 64 or 32).
// _rs: A from registers (the m16n8k16 A fragment of each warp's 16 rows),
// B MN-major (transpose bit set). accumulate == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64],
    uint64_t adesc, uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t adesc,
                                             uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t adesc,
                                             uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
    const uint32_t (&a)[4], uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
    const uint32_t (&a)[4], uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(accumulate));
}

// ---- f32 operands as bf16 planes ------------------------------------------
//
// wgmma multiplies bf16 (or TF32, about 11 bits) with f32 sums. An f32
// operand is written as bf16 planes, x = x0 + x1 (+ x2), x0 = bf16(x),
// x1 = bf16(x - x0), x2 = bf16(x - x0 - x1): two planes keep 16
// significant bits, three 24. A product of two planed operands sums the
// plane products whose order is below the kept precision, smallest
// first (see the note at the head of flash_prefill_bwd.cu). The helpers
// below serve a block of one warpgroup whose A tiles have 64 rows.

constexpr int PLANE_M = 64;           // rows of an A tile (wgmma's M)
constexpr int PLANE_THREADS = 128;    // the warpgroup that splits a tile
constexpr int SWIZZLE_ATOM = 8 * 128; // eight 128-byte rows

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// A tile of R rows x HD f32 that TMA has landed as dense rows at `region`,
// split in place into NP bf16 planes of R rows in the 128-byte swizzle
// (plane p at p * NH * R * 128). Every thread reads its share first, then
// the block waits, then the planes are written: the planes overlap the
// rows. Ends with the proxy fence; the caller's barrier publishes them.
template <int R, int HD, int NP>
__device__ __forceinline__ void split_tile(unsigned char* region) {
  constexpr int OCT = R * HD / 8;               // 8 floats: 16 B a plane
  constexpr int PER = OCT / PLANE_THREADS;
  constexpr int PLANE = (HD / 64) * R * 128;
  const float4* raw = reinterpret_cast<const float4*>(region);
  float4 x[PER][2];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int o = threadIdx.x + PLANE_THREADS * i;
    x[i][0] = raw[2 * o];
    x[i][1] = raw[2 * o + 1];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int o = threadIdx.x + PLANE_THREADS * i;
    const int r = o / (HD / 8), c8 = o % (HD / 8);
    const int off =
        (c8 >> 3) * R * 128 + r * 128 + (((c8 & 7) ^ (r & 7)) << 4);
    float v[8] = {x[i][0].x, x[i][0].y, x[i][0].z, x[i][0].w,
                  x[i][1].x, x[i][1].y, x[i][1].z, x[i][1].w};
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        const float2 f = __bfloat1622float2(h);
        v[2 * e] -= f.x;                        // exact: the rest of x
        v[2 * e + 1] -= f.y;
        w[e] = bf16x2_bits(h);
      }
      *reinterpret_cast<uint4*>(region + p * PLANE + off) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  fence_proxy_async();
}

// an accumulator of 64 rows x N (wgmma layout) as the A fragments of a
// product over its N columns, in two bf16 planes: f = f0 + f1
template <int N>
__device__ __forceinline__ void split_frag(const float (&f)[N],
                                           uint32_t (&a0)[N / 2],
                                           uint32_t (&a1)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    const float2 g = __bfloat1622float2(h);
    a0[i] = bf16x2_bits(h);
    a1[i] = bf16x2_bits(
        __floats2bfloat162_rn(f[2 * i] - g.x, f[2 * i + 1] - g.y));
  }
}

// K-major descriptor of a plane of `half` bytes a 64-column half, advanced
// to k-step kk (16 columns: 32 bytes along a row)
__device__ __forceinline__ uint64_t kmajor(uint32_t plane, int half, int kk) {
  const uint32_t off = (kk / 4) * half + (kk % 4) * 32;
  return smem_desc(plane + off, 16, SWIZZLE_ATOM);
}

// acc (64 x BN) = or += A B^T over HD, A a 64-row plane, B a plane of BN
// rows
template <int HD, int BN>
__device__ __forceinline__ void issue_ss(float (&acc)[BN / 2], uint32_t a,
                                         uint32_t b, bool first) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t ad = kmajor(a, PLANE_M * 128, kk);
    const uint64_t bd = kmajor(b, BN * 128, kk);
    const int accumulate = (first && kk == 0) ? 0 : 1;
    if constexpr (BN == 64) wgmma_ss_n64(acc, ad, bd, accumulate);
    else wgmma_ss_n32(acc, ad, bd, accumulate);
  }
}

// X = F S^T over the plane products whose order is below the kept
// precision, smallest first; F's planes are fplane bytes apart, S's splane
template <int HD, int BN, int NP>
__device__ __forceinline__ void issue_planes(float (&acc)[BN / 2],
                                             uint32_t f, uint32_t s,
                                             int fplane, int splane) {
  auto prod = [&](int i, int j, bool first) {
    issue_ss<HD, BN>(acc, f + i * fplane, s + j * splane, first);
  };
  if constexpr (NP == 3) {
    prod(1, 1, true);
    prod(2, 0, false);
    prod(0, 2, false);
    prod(1, 0, false);
    prod(0, 1, false);
    prod(0, 0, false);
  } else if constexpr (NP == 2) {
    prod(1, 0, true);
    prod(0, 1, false);
    prod(0, 0, false);
  } else {
    prod(0, 0, true);
  }
}

// acc (64 x HD) += A B, A in registers (64 x BN, fragments), B a plane of
// BN rows x HD, MN-major (transpose bit)
template <int HD, int BN>
__device__ __forceinline__ void issue_rs(float (&acc)[HD / 2],
                                         const uint32_t (&a)[BN / 4],
                                         uint32_t b) {
  const uint64_t desc = smem_desc(b, BN * 128, SWIZZLE_ATOM);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    const uint64_t d = desc + ((kk * 16 * 128) >> 4);
    if constexpr (HD == 128) wgmma_rs_n128(acc, f, d, 1);
    else wgmma_rs_n64(acc, f, d, 1);
  }
}

// acc += A B with A = a0 + a1 (f32 split in registers) and B of NP planes
// splane bytes apart (b0 + b1 + b2, b0 + b1 or b0), smallest terms
// first: a1 b0, a0 b1 (NP >= 2), a0 b0, and before them, with three
// planes of B, a1 b1 and a0 b2 (the terms of order 2^-16)
template <int HD, int BN, int NP>
__device__ __forceinline__ void issue_second(float (&acc)[HD / 2],
                                             const uint32_t (&a0)[BN / 4],
                                             const uint32_t (&a1)[BN / 4],
                                             uint32_t b, int splane) {
  if constexpr (NP == 3) {
    issue_rs<HD, BN>(acc, a1, b + splane);
    issue_rs<HD, BN>(acc, a0, b + 2 * splane);
  }
  issue_rs<HD, BN>(acc, a1, b);
  if constexpr (NP >= 2) issue_rs<HD, BN>(acc, a0, b + splane);
  issue_rs<HD, BN>(acc, a0, b);
}

// the registers of an A fragment that an asynchronous wgmma reads: this
// keeps the compiler from reusing them before the wait
template <int N> __device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace hopper
