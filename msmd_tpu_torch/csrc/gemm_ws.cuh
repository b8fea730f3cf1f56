// The guided window's layer kernels' products, K6 (ffn.cu) and K9
// (layer_tail.cu), on the warp-specialised Hopper GEMM pipeline of
// gemm_sm90.cuh (ws_gemm_tiles, which K1's four products run on too): this
// file gives it their weight layout, their epilogues and their launches.
// Included by ffn.cu and layer_tail.cu after decoder_common.cuh, whose wmma
// tile and ln_kernel stay the route of the shapes the pipeline does not
// take.
//
// The products: at the guided batch-48 shapes (K6: 96 x 111 = 10656 rows,
// K9: 96 x 110 = 10560 motion rows; F 512, FFN 2048) FFN1 (N 2048, K 512,
// GELU, bf16 h out) and the N = 512 residual products whose LayerNorm is
// taken in the epilogue: K6's FFN2 (K 2048), K9's self-out and cross-out
// (K 512) and FFN2. ~22 GFLOP a product against ~50 MB of operands: bound
// by the tensor cores, which only wgmma drives at their rate on Hopper.
//
// Design (the pipeline's own in gemm_sm90.cuh):
// - B is the weight in the nn.Linear (out, in) layout: (N, K) row-major is
//   K-major, so it is read as A is: a tensor map of boxes of 64 k x 256 rows
//   in the 128-byte swizzle, and a wgmma descriptor without the transposed-B
//   mode. No weight is copied.
// - FFN1 on 128 x 256 tiles; the N = 512 LayerNorm products as two-CTA
//   clusters over the 512 columns, each CTA a 128 x 256 tile of the same
//   rows, so B is read once per 128 rows. Each CTA copies the whole A box
//   itself: multicasting one 64-row half from each CTA into both halves the
//   A reads but ties each stage's release to the slower of the two CTAs,
//   and it ran the main loop about half as fast on the H100 (PERF.md). The
//   LayerNorm's row statistics cross the pair once a tile: each quad sends
//   its two rows' sums and sums of squared deviations from its half's mean
//   (WsPair), and each CTA combines the halves (Chan et al.).
// - Epilogues from the accumulators: FFN1 bf16(gelu(acc + bias)), the tanh
//   form (K6) or the Abramowitz & Stegun erf (K9); the LayerNorm products
//   y = res + (acc + bias) with res f32 or f32(bf16), LayerNorm in f32,
//   written as f32 x (may alias res), as bf16, or as both. The epilogue's
//   global accesses are 16-byte vectors (a transpose across each quad), the
//   residual rows are prefetched into the L2 during the main loop and loaded
//   in batches, so their latencies overlap.
// Rounding points are those of the wmma route (decoder_common.cuh) and of
// the plain versions in ops/kernels/gemm_ws.py.

#pragma once

#include <string.h>

#include "decoder_common.cuh"

namespace {

enum { WS_GELU = 0, WS_GELU_ERF = 1, WS_LN = 2 };

struct WsMaps {
  CUtensorMap a;  // A (M x K, K-major): boxes of 64 k x 128 rows
  CUtensorMap b;  // the weight (N x K, nn.Linear layout): boxes of 64 k x 256 rows
};

struct WsArgs {
  const bf16* bias;  // N, or null
  const void* res;   // WS_LN: M x N residual, f32 if res_f32, else bf16
  int res_f32;
  float* x;          // WS_LN: M x N f32 LayerNorm output, or null; may alias res
  bf16* out;         // M x N bf16: the GELU output, or the LayerNorm output's bf16 copy (or null)
  const float* ln_scale;
  const float* ln_bias;
  int M, N, K;
};

// The products the warp-specialized GEMM takes: enough rows, K in whole
// stages, N in whole 256-column tiles, or N == 512 (two CTAs) for the
// LayerNorm epilogue.
__host__ __device__ inline bool ws_wide_ok(int M, int N, int K) {
  return M >= SM90_MIN_ROWS && K > 0 && K % WS_BK == 0 && N > 0 && N % WS_BN == 0;
}
__host__ __device__ inline bool ws_ln_ok(int M, int N, int K) {
  return M >= SM90_MIN_ROWS && K > 0 && K % WS_BK == 0 && N == 2 * WS_BN;
}

// The epilogue's erf GELU, decoder_common.cuh's gelu_erf evaluated as
// gelu_tanh_fast evaluates gelu_tanh: the Abramowitz & Stegun erf through
// the exp and reciprocal intrinsics (with an IEEE reciprocal here K9's
// FFN1 ran far slower than K6's on the card).
__device__ __forceinline__ float ws_gelu_erf(float u) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f, a4 = -1.453152027f,
              a5 = 1.061405429f, p = 0.3275911f;
  const float z = u * 0.70710677f, az = fabsf(z);
  const float t = __fdividef(1.0f, 1.0f + p * az);
  const float poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t;
  const float e = 1.0f - poly * __expf(-az * az);  // erf(|z|)
  return u * 0.5f * (1.0f + (z < 0.0f ? -e : e));
}

// The residual of row r, group 4 jg + q (from column c): 16 bytes of bf16
// (raw[0]) or 32 of f32 (raw[0], raw[1]); zeros past the rows.
__device__ __forceinline__ void ws_load_res(const WsArgs& g, int r, int c, uint4 (&raw)[2]) {
  if (g.res_f32) {
    ws_load_f32(static_cast<const float*>(g.res), g.M, g.N, r, c, raw);
  } else {
    raw[0] = ws_load_bf16(static_cast<const bf16*>(g.res), g.M, g.N, r, c);
    raw[1] = make_uint4(0u, 0u, 0u, 0u);
  }
}
// this lane's residual pairs of groups 4 jg + k (res[k]) from the quad's raw loads
__device__ __forceinline__ void ws_unpack_res(const WsArgs& g, const uint4 (&raw)[2], float2 (&res)[4], int q) {
  if (g.res_f32) {
    ws_unpack_f32(raw, res, q);
  } else {
    ws_unpack_bf16(raw[0], res, q);
  }
}

// The GELU epilogue of a 128 x 256 tile: this thread's accumulators d[4j +
// {0, 1}] are (row r0, columns n0 + 8 j + 2 q + {0, 1}), d[4j + {2, 3}] row
// r0 + 8.
template <int EPI>
__device__ __forceinline__ void ws_epilogue_gelu(const WsArgs& g, float (&d)[128], int r0, int n0, int q) {
#pragma unroll
  for (int jg = 0; jg < 8; ++jg) {
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * jg + k, c = n0 + 8 * j + 2 * q;
      float2 bj = make_float2(0.0f, 0.0f);
      if (g.bias) bj = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + c));
      float v[4] = {d[4 * j] + bj.x, d[4 * j + 1] + bj.y, d[4 * j + 2] + bj.x, d[4 * j + 3] + bj.y};
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = EPI == WS_GELU ? gelu_tanh_fast(v[t]) : ws_gelu_erf(v[t]);
      lo[k] = pack_bf16x2(v[0], v[1]);
      hi[k] = pack_bf16x2(v[2], v[3]);
    }
    const int c = n0 + 8 * (4 * jg + q);
    ws_store_bf16(g.out, g.M, g.N, r0, c, lo, q);
    ws_store_bf16(g.out, g.M, g.N, r0 + 8, c, hi, q);
  }
}

// The mean and 1 / sqrt(variance + eps) of a row of n = 2h columns from the
// two halves' sums and sums of squared deviations from their own means
// (Chan et al.'s pairwise combination); symmetric in the halves, so both
// CTAs of a pair compute the same bits.
__device__ __forceinline__ float2 ws_row_stats(float s_own, float m2_own, float s_peer, float m2_peer, int n) {
  const float h = 0.5f * n;
  const float delta = s_peer / h - s_own / h;
  const float m2 = (m2_own + m2_peer) + delta * delta * (0.25f * n);
  return make_float2((s_own + s_peer) / n, rsqrtf(m2 / n + 1e-5f));
}

// The LayerNorm epilogue of this CTA's 128 x 256 half of a 128 x 512 row
// block: y = res + (acc + bias), the row statistics over both halves, then
// x (f32, if g.x) and out (bf16), one exchange of the pair a tile.
__device__ __forceinline__ void ws_epilogue_ln(const WsArgs& g, float (&d)[128], int r0, int n0, WsPair& pair,
                                               int lane) {
  const int r1 = r0 + 8, half = g.N / 2, q = lane % 4;
  float s_lo = 0.0f, s_hi = 0.0f;
#pragma unroll
  for (int jb = 0; jb < 8; jb += 4) {  // two batches of four groups' residual loads
    uint4 raw0[4][2], raw1[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      ws_load_res(g, r0, n0 + 8 * (4 * (jb + jj) + q), raw0[jj]);
      ws_load_res(g, r1, n0 + 8 * (4 * (jb + jj) + q), raw1[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float2 x0[4], x1[4];
      ws_unpack_res(g, raw0[jj], x0, q);
      ws_unpack_res(g, raw1[jj], x1, q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * (jb + jj) + k, c = n0 + 8 * j + 2 * q;
        float2 bj = make_float2(0.0f, 0.0f);
        if (g.bias) bj = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + c));
        d[4 * j] = x0[k].x + (d[4 * j] + bj.x);
        d[4 * j + 1] = x0[k].y + (d[4 * j + 1] + bj.y);
        d[4 * j + 2] = x1[k].x + (d[4 * j + 2] + bj.x);
        d[4 * j + 3] = x1[k].y + (d[4 * j + 3] + bj.y);
        s_lo += d[4 * j] + d[4 * j + 1];
        s_hi += d[4 * j + 2] + d[4 * j + 3];
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s_lo += __shfl_xor_sync(0xffffffffu, s_lo, o);
    s_hi += __shfl_xor_sync(0xffffffffu, s_hi, o);
  }
  const float m_lo = s_lo / half, m_hi = s_hi / half;  // this half's means
  float q_lo = 0.0f, q_hi = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    q_lo += (d[4 * j] - m_lo) * (d[4 * j] - m_lo) + (d[4 * j + 1] - m_lo) * (d[4 * j + 1] - m_lo);
    q_hi += (d[4 * j + 2] - m_hi) * (d[4 * j + 2] - m_hi) + (d[4 * j + 3] - m_hi) * (d[4 * j + 3] - m_hi);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    q_lo += __shfl_xor_sync(0xffffffffu, q_lo, o);
    q_hi += __shfl_xor_sync(0xffffffffu, q_hi, o);
  }
  const float4 p = pair.exchange(make_float4(s_lo, s_hi, q_lo, q_hi), lane);
  const float2 st_lo = ws_row_stats(s_lo, q_lo, p.x, p.z, g.N), st_hi = ws_row_stats(s_hi, q_hi, p.y, p.w, g.N);
#pragma unroll
  for (int jg = 0; jg < 8; ++jg) {
    uint32_t lo[4], hi[4], xl[4], yl[4], xh[4], yh[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * jg + k, c = n0 + 8 * j + 2 * q;
      const float2 gs = *reinterpret_cast<const float2*>(g.ln_scale + c);
      const float2 gb = *reinterpret_cast<const float2*>(g.ln_bias + c);
      const float2 o0 = make_float2((d[4 * j] - st_lo.x) * st_lo.y * gs.x + gb.x,
                                    (d[4 * j + 1] - st_lo.x) * st_lo.y * gs.y + gb.y);
      const float2 o1 = make_float2((d[4 * j + 2] - st_hi.x) * st_hi.y * gs.x + gb.x,
                                    (d[4 * j + 3] - st_hi.x) * st_hi.y * gs.y + gb.y);
      lo[k] = pack_bf16x2(o0.x, o0.y);
      hi[k] = pack_bf16x2(o1.x, o1.y);
      xl[k] = __float_as_uint(o0.x), yl[k] = __float_as_uint(o0.y);
      xh[k] = __float_as_uint(o1.x), yh[k] = __float_as_uint(o1.y);
    }
    const int cg = n0 + 8 * (4 * jg + q);
    if (g.out) {
      ws_store_bf16(g.out, g.M, g.N, r0, cg, lo, q);
      ws_store_bf16(g.out, g.M, g.N, r1, cg, hi, q);
    }
    if (g.x) {
      ws_store_f32(g.x, g.M, g.N, r0, cg, xl, yl, q);
      ws_store_f32(g.x, g.M, g.N, r1, cg, xh, yh, q);
    }
  }
}

// K6's and K9's products on the warp-specialised pipeline (gemm_sm90.cuh):
// B in the nn.Linear layout, A in boxes of 128 rows, the GELU epilogues
// on 128 x 256 tiles, the LayerNorm one as two-CTA clusters.
template <int EPI>
struct WsEpi {
  using Args = WsArgs;
  static constexpr bool LN = EPI == WS_LN, B_MN = false;
  static constexpr int A_BOX = WS_BM, EXTRA = 0;

  static __device__ __forceinline__ void prefetch(const WsArgs& g, int r, int n0, int q) {
    if constexpr (LN) ws_prefetch_rows(g.res, g.res_f32 ? 4 : 2, g.M, g.N, r, n0, q);
  }
  static __device__ __forceinline__ void setup(const WsArgs&, int, float*) {}
  static __device__ __forceinline__ void epilogue(const WsArgs& g, float (&d)[128], int r0, int n0, int lane,
                                                  WsPair& pair, const float*) {
    if constexpr (LN) {
      ws_epilogue_ln(g, d, r0, n0, pair, lane);
    } else {
      ws_epilogue_gelu<EPI>(g, d, r0, n0, lane % 4);
    }
  }
};

template <int EPI>
__global__ void __launch_bounds__(WS_THREADS, 1) gemm_ws_kernel(const __grid_constant__ WsMaps maps, const WsArgs g) {
  extern __shared__ __align__(128) unsigned char ws_smem[];
  ws_gemm_tiles<WsEpi<EPI>>(&maps.a, &maps.b, 0, g, ws_smem);
}

// The persistent launch: WS_GELU / WS_GELU_ERF min(tiles, SMs) blocks;
// WS_LN min(row blocks, SMs / 2) clusters of two.
template <int EPI>
cudaError_t gemm_ws(cudaStream_t st, const WsMaps& maps, const WsArgs& g) {
  static bool attr_set = false;
  return ws_launch(gemm_ws_kernel<EPI>, &attr_set, EPI == WS_LN, WS_SMEM, st, maps, g);
}

// the tensor map of a weight (N, K) in the nn.Linear layout
inline cudaError_t make_w_map(CUtensorMap* map, const bf16* W, int N, int K) {
  return make_map(map, W, K, N, 1, K, (long)K * N, WS_BN);
}

cudaError_t ws_wmma_attributes() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  RETURN_IF_ERROR((gemm_attrs<EPI_GELU, true>()));
  RETURN_IF_ERROR((gemm_attrs<EPI_GELU_ERF, true>()));
  RETURN_IF_ERROR((gemm_attrs<EPI_RESID, true>()));
  RETURN_IF_ERROR((gemm_attrs<EPI_RESID_BF16, true>()));
  attr_set = true;
  return cudaSuccess;
}

// One product of K6 or K9: A (M, K) bf16 row-major, W (N, K) bf16 (the
// nn.Linear layout), bias (N) bf16. WS_GELU / WS_GELU_ERF: out (M, N) bf16.
// WS_LN: LayerNorm(res + (A W^T + bias)) * lns + lnb, res (M, N) f32 or
// bf16, into x (f32, or null; may be res) and out (bf16; null on the
// warp-specialized route writes no bf16 copy). route 0 takes the
// warp-specialized GEMM where the shape allows (ws_wide_ok, ws_ln_ok), else
// the wmma tile (and for WS_LN an ln_kernel pass over the f32 scratch y, M x
// N); 1 the warp-specialized GEMM (refused where the shape does not take
// it); 2 the wmma tile. wmap: W's tensor map (make_w_map), or null to make
// it here.
cudaError_t ws_product(cudaStream_t st, int route, int epi, const bf16* A, const CUtensorMap* wmap, const bf16* W,
                       const bf16* bias, const void* res, bool res_f32, float* x, bf16* out, const float* lns,
                       const float* lnb, float* y, int M, int N, int K) {
  const bool ln = epi == WS_LN;
  const bool fits = ln ? ws_ln_ok(M, N, K) : ws_wide_ok(M, N, K);
  if (route < 0 || route > 2 || (route == 1 && !fits)) return cudaErrorInvalidValue;
  if (route == 1 || (route == 0 && fits)) {
    WsMaps maps;
    RETURN_IF_ERROR(make_a_map(&maps.a, A, K, M, K, WS_BM));
    if (wmap) {
      memcpy(&maps.b, wmap, sizeof(CUtensorMap));
    } else {
      RETURN_IF_ERROR(make_w_map(&maps.b, W, N, K));
    }
    const WsArgs g{bias, res, res_f32 ? 1 : 0, x, out, lns, lnb, M, N, K};
    if (ln) return gemm_ws<WS_LN>(st, maps, g);
    return epi == WS_GELU ? gemm_ws<WS_GELU>(st, maps, g) : gemm_ws<WS_GELU_ERF>(st, maps, g);
  }
  RETURN_IF_ERROR(ws_wmma_attributes());
  if (!ln) {
    return epi == WS_GELU ? gemm<EPI_GELU, true>(st, A, K, nullptr, W, bias, nullptr, out, M, N, K)
                          : gemm<EPI_GELU_ERF, true>(st, A, K, nullptr, W, bias, nullptr, out, M, N, K);
  }
  if (y == nullptr || out == nullptr || N > 32 * LN_MAXN) return cudaErrorInvalidValue;
  if (res_f32) {
    RETURN_IF_ERROR((gemm<EPI_RESID, true>(st, A, K, nullptr, W, bias, static_cast<const float*>(res), y, M, N, K)));
  } else {
    RETURN_IF_ERROR((gemm<EPI_RESID_BF16, true>(st, A, K, nullptr, W, bias, nullptr, y, M, N, K, 1.0f, 0, nullptr,
                                                 static_cast<const bf16*>(res))));
  }
  ln_kernel<false, bf16><<<(M * 32 + LN_THREADS - 1) / LN_THREADS, LN_THREADS, 0, st>>>(
      y, x, out, lns, lnb, M, N, nullptr, nullptr, nullptr, nullptr, 1);
  return cudaGetLastError();
}

}  // namespace

// What ws_product's route 0 runs for one product: out = {1 for the
// warp-specialized GEMM or 0 for the wmma tile, tile rows, tile columns,
// CTAs per cluster, tiles (of one CTA), grid blocks, dynamic shared-memory
// bytes}; all -1 for a shape or epilogue that neither takes.
extern "C" void msmd_ws_gemm_plan(int M, int N, int K, int epi, long* out) {
  for (int i = 0; i < 7; ++i) out[i] = -1;
  const bool ln = epi == WS_LN;
  if (M < 1 || N < 1 || K < 1 || N % BN || K % BK || epi < 0 || epi > WS_LN) return;
  const int rb = (M + WS_BM - 1) / WS_BM, sms = sm_count();
  if (ln ? ws_ln_ok(M, N, K) : ws_wide_ok(M, N, K)) {
    const int tiles = ln ? 2 * rb : (N / WS_BN) * rb;
    const long plan[7] = {1, WS_BM, WS_BN, ln ? 2 : 1, tiles, ws_grid(ln, M, N, sms),
                          static_cast<long>(WS_SMEM)};
    for (int i = 0; i < 7; ++i) out[i] = plan[i];
    return;
  }
  if (ln && N > 32 * LN_MAXN) return;
  const int bm = N > 512 ? 128 : 64, tiles = (N / BN) * ((M + bm - 1) / bm);
  const long plan[7] = {0, bm, BN, 1, tiles, tiles,
                        static_cast<long>(bm == 128 ? gemm_smem_bytes<128, true>() : gemm_smem_bytes<64, true>())};
  for (int i = 0; i < 7; ++i) out[i] = plan[i];
}

// The tensor map of a weight W (N, K) bf16 in the nn.Linear layout, encoded
// into `out` (sizeof(CUtensorMap) = 128 bytes), for the calls that pass it
// in place of making it: the guided kernels' prepared weights.
extern "C" int msmd_ws_weight_map(const void* W, int N, int K, void* out) {
  CUtensorMap m;
  const cudaError_t err = make_w_map(&m, static_cast<const bf16*>(W), N, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  memcpy(out, &m, sizeof m);
  return 0;
}

// One product alone, for the card tests and chip_smoke.py's per-product
// times: ws_product with res (f32 if res_f32, else bf16), x (f32 or null),
// out (bf16), y (the wmma LayerNorm route's scratch, or null). Launches on
// `stream`; returns the first CUDA error or 0.
extern "C" int msmd_ws_gemm(int route, int epi, const void* A, const void* W, const void* bias, const void* res,
                            int res_f32, void* x, void* out, const void* ln_scale, const void* ln_bias, void* y,
                            int M, int N, int K, void* stream) {
  long plan[7];
  msmd_ws_gemm_plan(M, N, K, epi, plan);
  if (plan[0] < 0) return cudaErrorInvalidValue;
  return static_cast<int>(ws_product(static_cast<cudaStream_t>(stream), route, epi, static_cast<const bf16*>(A),
                                     nullptr, static_cast<const bf16*>(W), static_cast<const bf16*>(bias), res,
                                     res_f32 != 0, static_cast<float*>(x), static_cast<bf16*>(out),
                                     static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
                                     static_cast<float*>(y), M, N, K));
}
