// EDT pass-2 min-plus for Hopper:
//   out[r, q] = min over s in [lo, hi) of g2[r, s] + (qcol[q] - s)^2
//
// Replaces leafgrasp_tpu/ops/pallas_edt.py squared_edt_pass2 /
// _pass2_kernel (:65 / :41) and squared_edt_pass2_banded /
// _banded_kernel (:119 / :90), and serves every min-plus of
// leafgrasp_tpu/ops/edt.py (full sweep, banded sweep, query window,
// sampled envelope, refinement windows).
//
// Bound: operations. Counted as an add and a min for each (row, query,
// source) triple, the full 1080 x 1440 x 1440 sweep is 4.5 G operations
// over 12 MB: 0.067 ms at the card's 67 TFLOP/s, far right of the ridge.
// That figure counts a fused multiply-add as two operations and lets a
// min run at the add's rate; an SM issues one warp instruction a cycle in
// each of its four partitions and runs min and max at half the rate of
// add and multiply, so a triple that costs a multiply-add and a min
// cannot take less than two cycles a warp: 2.24 G triples / (132 SMs x 4
// x 32 lanes) x 2 cycles at the card's highest clock of 1.98 GHz is
// 0.13 ms, the floor of this design. TMA and wgmma have nothing to
// offer: an f32 min-plus is not a matrix product, and the staged tile of
// a warp is 4 KB.
//
// Design. The square is expanded,
//   g2[r, s] + (q - s)^2 = (g2[r, s] + s^2) - 2 q s + q^2,
// so that h[r][s] = g2[r, s] + s^2 is staged once per value in shared
// memory, the inner loop is acc = fminf(acc, fmaf(-2q, s, h)) (two
// instructions a triple; the direct form below costs two as well where
// the tile's rows share the square), and q^2 is added once at the store.
// A warp owns one band tile:
// MP_ROWS rows x 32 * QPT query columns (QPT query columns and MP_ROWS
// rows a thread, 8 * QPT accumulators), and reads h as float4 over s, one
// broadcast 16-byte load for 4 * QPT triples, so the loop is bound by the
// issue of arithmetic and not by shared memory. The four warps of a block
// share ONE tile and split its source range in four; each stages only
// its own quarter (no block barrier in the loop, the next quarter-chunk
// is fetched into registers while this one is multiplied) and the four
// partial minima meet in shared memory at the end. A tile a block, not a
// tile a warp, gives the full sweep 1620 blocks for 132 SMs where it
// would give a partition three or four tiles. QPT is chosen by the
// launcher from nq: 4 for wide query sets, 1 for narrow ones (the 17
// columns of a refinement window would leave most lanes of a wider tile
// idle). A per-(row tile, 128-column chunk) band radius narrows the
// sources to the chunks that can win (the banded form); a tile never
// straddles a chunk.
//
// Exactness. In the expanded form every value is an integer: the callers
// keep g2 <= 2^24 - 2 W^2 where it is finite (the wrapper states it), so
// h < 2^24, -2 q s >= -2 W^2, and h - 2 q s = g2 + (q - s)^2 - q^2 lies in
// (-2^24, 2^24): the fused multiply-add rounds once and that once is
// exact, as is the final + q^2. INFINITY (a source out of range) stays
// infinite through the multiply-add. The result is bit for bit that of
// any other evaluation order. The file is built with -fmad=false; the
// multiply-add is the explicit intrinsic.
//
// The direct form (DIRECT = true) serves every call outside the expanded
// form's range: frames whose sentinel (H + W)^2 leaves no room for the
// expansion (2048 x 2448, 2160 x 3840, 2100 x 1600), and calls that state
// no bound. It stages g2 as it is and adds no q^2 at the store; a triple
// costs d = q - s and dd = d * d (once for the tile's eight rows where the
// query columns are shared), g2 + dd and a min. The square and the sum
// are rounded one after the other (__fmul_rn, then __fadd_rn), as the
// plain version and the JAX package compute g2 + (q - s)^2: the square
// is exact while W <= 4097 and rounds alike everywhere past that, the sum
// rounds once, and rounding is monotone, so the minimum is theirs bit for
// bit whatever the values, past 2^24 included (a seedless frame's
// sentinel). The wrapper picks the form from the bound its caller states
// and W alone (kernels/minplus.py minplus_form).

#include <cuda_runtime.h>
#include <math.h>

#define MP_ROWS 8        // rows of a tile: the band's row tile
#define MP_CHUNK 128     // columns of a band chunk
#define MP_WARPS 4       // warps of a block: quarters of the source range
#define MP_SC 128        // sources a warp stages at a time
#define MP_LD (MP_SC / 32)

template <int QPT, bool PER_ROW, bool DIRECT>
__global__ void __launch_bounds__(MP_WARPS * 32)
minplus_pass2_kernel(const float* __restrict__ g2, int R, int W,
                     const int* __restrict__ qcol, int nq, int s_lo,
                     int s_hi, const int* __restrict__ band,
                     int n_band_cols, float* __restrict__ out) {
  constexpr int QM = PER_ROW ? MP_ROWS : 1;     // distinct query sets
  __shared__ __align__(16) float sh[MP_WARPS][MP_ROWS][MP_SC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qbase = blockIdx.x * (32 * QPT);
  const int rt = blockIdx.y;
  const int r0 = rt * MP_ROWS;

  // -2 q (expanded) or q (direct) for this thread's query columns, per row
  // in the refinement form
  float m2q[QM][QPT];
#pragma unroll
  for (int m = 0; m < QM; ++m) {
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int q = qbase + j * 32 + lane;
      const int rr = r0 + m;
      int qc = 0;
      if (q < nq && rr < R)
        qc = PER_ROW ? qcol[(size_t)rr * nq + q] : qcol[q];
      m2q[m][j] = DIRECT ? (float)qc : -2.0f * (float)qc;
    }
  }
  float acc[MP_ROWS][QPT];
#pragma unroll
  for (int r = 0; r < MP_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[r][j] = INFINITY;

  int lo = s_lo, hi = s_hi;
  if (band != nullptr) {
    const int qt = qbase / MP_CHUNK;
    const int nb = band[rt * n_band_cols + qt];
    lo = max(lo, (qt - nb) * MP_CHUNK);
    hi = min(hi, (qt + nb + 1) * MP_CHUNK);
  }
  // this warp's quarter of [lo, hi), a multiple of 4 sources long
  const int span = max(hi - lo, 0);
  const int quarter = (((span + MP_WARPS - 1) / MP_WARPS) + 3) & ~3;
  const int wlo = lo + warp * quarter;
  const int whi = min(hi, wlo + quarter);

  float pre[MP_ROWS][MP_LD];                    // the next chunk, raw
  auto fetch = [&](int s0) {
#pragma unroll
    for (int r = 0; r < MP_ROWS; ++r) {
      const int rr = r0 + r;
#pragma unroll
      for (int i = 0; i < MP_LD; ++i) {
        const int s = s0 + i * 32 + lane;
        pre[r][i] = (rr < R && s < whi) ? g2[(size_t)rr * W + s] : INFINITY;
      }
    }
  };
  if (wlo < whi) fetch(wlo);
  for (int s0 = wlo; s0 < whi; s0 += MP_SC) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MP_LD; ++i) {
      const float sf = (float)(s0 + i * 32 + lane);
      const float s2 = DIRECT ? 0.0f : sf * sf;
#pragma unroll
      for (int r = 0; r < MP_ROWS; ++r)
        sh[warp][r][i * 32 + lane] = pre[r][i] + s2;     // inf stays inf
    }
    __syncwarp();
    if (s0 + MP_SC < whi) fetch(s0 + MP_SC);
    const int n = min(MP_SC, whi - s0);         // the tail beyond n is inf
    float sf = (float)s0;
    for (int s = 0; s < n; s += 4) {
      float4 hv[MP_ROWS];
#pragma unroll
      for (int r = 0; r < MP_ROWS; ++r)
        hv[r] = *reinterpret_cast<const float4*>(&sh[warp][r][s]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dd[QM][QPT];                      // (q - s)^2, direct form only
        if (DIRECT) {
#pragma unroll
          for (int m = 0; m < QM; ++m)
#pragma unroll
            for (int j = 0; j < QPT; ++j) {
              const float d = m2q[m][j] - sf;
              dd[m][j] = __fmul_rn(d, d);
            }
        }
#pragma unroll
        for (int r = 0; r < MP_ROWS; ++r) {
          const float h = e == 0 ? hv[r].x : e == 1 ? hv[r].y
                        : e == 2 ? hv[r].z : hv[r].w;
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            const int m = PER_ROW ? r : 0;
            acc[r][j] = fminf(acc[r][j],
                              DIRECT ? __fadd_rn(dd[m][j], h)
                                     : __fmaf_rn(m2q[m][j], sf, h));
          }
        }
        sf += 1.0f;
      }
    }
  }

  // the four partial minima meet: each warp leaves its own in its staging
  // area (8 * QPT floats a lane), then finishes two of the eight rows
  __syncwarp();
  float* mine = &sh[warp][0][0];
#pragma unroll
  for (int r = 0; r < MP_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < QPT; ++j)
      mine[(r * QPT + j) * 32 + lane] = acc[r][j];
  __syncthreads();
  constexpr int RPW = MP_ROWS / MP_WARPS;
#pragma unroll
  for (int r = 0; r < MP_ROWS; ++r) {           // r static: m2q in registers
    if (r / RPW != warp) continue;
    const int rr = r0 + r;
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int q = qbase + j * 32 + lane;
      float v = INFINITY;
#pragma unroll
      for (int w = 0; w < MP_WARPS; ++w)
        v = fminf(v, (&sh[w][0][0])[(r * QPT + j) * 32 + lane]);
      const float m = m2q[PER_ROW ? r : 0][j];
      if (q < nq && rr < R)
        out[(size_t)rr * nq + q] = DIRECT ? v : v + 0.25f * (m * m);  // + q^2
    }
  }
}

template <int QPT, bool PER_ROW, bool DIRECT>
static int launch(const float* g2, int R, int W, const int* qcol, int nq,
                  int s_lo, int s_hi, const int* band, int n_band_cols,
                  float* out, cudaStream_t stream) {
  dim3 grid((nq + 32 * QPT - 1) / (32 * QPT), (R + MP_ROWS - 1) / MP_ROWS);
  minplus_pass2_kernel<QPT, PER_ROW, DIRECT>
      <<<grid, MP_WARPS * 32, 0, stream>>>(g2, R, W, qcol, nq, s_lo, s_hi,
                                          band, n_band_cols, out);
  return (int)cudaGetLastError();
}

template <bool DIRECT>
static int launch_form(const float* g2, int R, int W, const int* qcol,
                       int nq, int per_row, int s_lo, int s_hi,
                       const int* band, int n_band_cols, float* out,
                       cudaStream_t stream) {
  if (per_row)
    return launch<1, true, DIRECT>(g2, R, W, qcol, nq, s_lo, s_hi, band,
                                   n_band_cols, out, stream);
  if (nq >= MP_CHUNK)
    return launch<4, false, DIRECT>(g2, R, W, qcol, nq, s_lo, s_hi, band,
                                    n_band_cols, out, stream);
  return launch<1, false, DIRECT>(g2, R, W, qcol, nq, s_lo, s_hi, band,
                                  n_band_cols, out, stream);
}

// g2 (R, W) f32; qcol int32 (nq,) or, with per_row, (R, nq); band int32
// (ceil(R / 8), n_band_cols) or null; out (R, nq) f32; direct selects the
// direct form. The tile's width follows nq: 128 query columns where there
// are that many, else 32.
extern "C" int minplus_pass2(const float* g2, int R, int W, const int* qcol,
                             int nq, int per_row, int s_lo, int s_hi,
                             const int* band, int n_band_cols, int direct,
                             float* out, cudaStream_t stream) {
  if (R <= 0 || nq <= 0) return 0;
  if (direct)
    return launch_form<true>(g2, R, W, qcol, nq, per_row, s_lo, s_hi, band,
                             n_band_cols, out, stream);
  return launch_form<false>(g2, R, W, qcol, nq, per_row, s_lo, s_hi, band,
                            n_band_cols, out, stream);
}
