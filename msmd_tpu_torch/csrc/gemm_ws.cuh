// The warp-specialized Hopper GEMM of the guided window's layer kernels,
// K6 (ffn.cu) and K9 (layer_tail.cu), hand-written for sm_90a:
// wgmma.mma_async m64n256k16 (bf16 in, f32 accumulation in registers) on
// operands that TMA copies into 128-byte-swizzled shared memory, with the
// epilogues those kernels need. Included by ffn.cu and layer_tail.cu after
// decoder_common.cuh, whose TMA map encoder, wgmma and mbarrier helpers
// (gemm_sm90.cuh) it uses, and whose wmma tile and ln_kernel stay the route
// of the shapes this GEMM does not take.
//
// The products: at the guided batch-48 shapes (K6: 96 x 111 = 10656 rows,
// K9: 96 x 110 = 10560 motion rows; F 512, FFN 2048) FFN1 (N 2048, K 512,
// GELU, bf16 h out) and the N = 512 residual products whose LayerNorm is
// taken in the epilogue: K6's FFN2 (K 2048), K9's self-out and cross-out
// (K 512) and FFN2. ~22 GFLOP a product against ~50 MB of operands: bound
// by the tensor cores, which only wgmma drives at their rate on Hopper.
//
// Design:
// - B is the weight in the nn.Linear (out, in) layout: (N, K) row-major is
//   K-major, so it is read as A is: a tensor map of boxes of 64 k x 256 rows
//   in the 128-byte swizzle, and a wgmma descriptor without the transposed-B
//   mode. No weight is copied.
// - 384 threads: consumer warpgroups 0 and 1 (setmaxnreg.inc to 232
//   registers), each holding a 64 x 256 f32 accumulator (128 registers a
//   thread), stacked in M for a 128 x 256 tile; producer warpgroup 2
//   (setmaxnreg.dec to 40), one of whose threads issues every TMA copy.
// - A ring of WS_STAGES stages of 64 k (A 128 x 64, B 256 x 64: 48 KB), each
//   with a full mbarrier (the copies' bytes) and an empty one (one arrival
//   per consumer warpgroup when its wgmma have read the stage): no block
//   barrier in the main loop, and each warpgroup keeps up to two wgmma
//   groups in flight. A persistent grid walks the tiles, and the ring runs
//   on from one tile of a block to its next, so the next tile's loads
//   overlap the last one's epilogue.
// - The N = 512 LayerNorm products run as two-CTA clusters over the 512
//   columns: each CTA takes a 128 x 256 tile of the same rows, so B is read
//   once per 128 rows (87 operations a byte of B, against 58 for K1's
//   64 x 512 tiles). Each CTA copies the whole A box itself: multicasting
//   one 64-row half from each CTA into both halves the A reads but ties each
//   stage's release to the slower of the two CTAs, and it ran the main loop
//   about half as fast on the H100 (PERF.md). The LayerNorm's row
//   statistics cross the pair through distributed shared memory once a
//   tile: each quad's first lane stores its two rows' sums and sums of
//   squared deviations from its half's mean into the peer's buffer
//   (st.shared::cluster at a mapa address) and arrives on the peer's
//   mbarrier with release at cluster scope; the peer waits with acquire and
//   combines the halves (Chan et al.). Two buffers are enough: a CTA gets
//   past tile t's exchange only once its peer has sent tile t's statistics,
//   which the peer does after reading tile t - 1's.
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

constexpr int WS_THREADS = 384;  // two consumer warpgroups, then the producer warpgroup
constexpr int WS_BM = 128, WS_BN = 256, WS_BK = 64;
constexpr int WS_STAGES = 4;
constexpr int WS_A_BYTES = WS_BM * WS_BK * 2, WS_B_BYTES = WS_BN * WS_BK * 2, WS_STAGE = WS_A_BYTES + WS_B_BYTES;
constexpr int WS_NB = 2;                                             // LayerNorm exchange buffers
constexpr int WS_PART_BYTES = WS_NB * 2 * WS_BM * (int)sizeof(float);  // [buffer][quad] float4
constexpr int WS_BARS = 2 * WS_STAGES + WS_NB;                       // full, empty, exchange
// the ring, 1024 bytes of slack to align it to the swizzle atom, the
// exchange buffers and the mbarriers
constexpr size_t WS_SMEM = (size_t)WS_STAGES * WS_STAGE + 1024 + WS_PART_BYTES + WS_BARS * sizeof(uint64_t);

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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of `local` (a shared::cta address) in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// an arrival on an mbarrier of any CTA of the cluster, releasing this
// thread's earlier writes at cluster scope
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t cluster_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(cluster_bar) : "memory");
}
__device__ __forceinline__ void mbar_wait_acquire_cluster(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_CL:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_CL;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
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

// A consumer warpgroup is done reading a stage: one arrival on its empty barrier.
__device__ __forceinline__ void ws_release(uint64_t* empty_bar, int thread_in_wg) {
  if (thread_in_wg == 0) mbar_arrive(empty_bar);
}

// The epilogues' global accesses go through the 4 lanes of a quad, which
// hold the same rows: in the accumulator layout lane q has columns 8 j + 2 q
// and 8 j + 2 q + 1 of 8-column group j; a 4 x 4 transpose over groups
// 4 jg .. 4 jg + 3 gives lane q the whole group 4 jg + q (16 bytes of bf16,
// 32 of f32), so each warp access is 8 rows x 64 contiguous bytes of 16-byte
// vectors, not 8 rows x 16 bytes of 4-byte words.

// lane q's v[k] becomes lane k's v[q] (q = lane % 4); a transpose is its own inverse
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
#pragma unroll
  for (int k = 0; k < 4; k += 2) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, (q & 1) ? v[k] : v[k + 1], 1);
    if (q & 1) {
      v[k] = r;
    } else {
      v[k + 1] = r;
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, (q & 2) ? v[k] : v[k + 2], 2);
    if (q & 2) {
      v[k] = r;
    } else {
      v[k + 2] = r;
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Row r of a bf16 (M x N) matrix, group 4 jg + q (from column c = n0 + 8 (4 jg
// + q)), stored from this lane's pairs v[k] of groups 4 jg + k.
__device__ __forceinline__ void ws_store_bf16(bf16* p, int M, int N, int r, int c, uint32_t (&v)[4], int q) {
  quad_transpose(v, q);
  if (r < M) *reinterpret_cast<uint4*>(p + (long)r * N + c) = make_uint4(v[0], v[1], v[2], v[3]);
}
// the same for f32 pairs (x[k], y[k]) of groups 4 jg + k
__device__ __forceinline__ void ws_store_f32(float* p, int M, int N, int r, int c, uint32_t (&x)[4], uint32_t (&y)[4],
                                             int q) {
  quad_transpose(x, q);
  quad_transpose(y, q);
  if (r < M) {
    float4* o = reinterpret_cast<float4*>(p + (long)r * N + c);
    o[0] = make_float4(__uint_as_float(x[0]), __uint_as_float(y[0]), __uint_as_float(x[1]), __uint_as_float(y[1]));
    o[1] = make_float4(__uint_as_float(x[2]), __uint_as_float(y[2]), __uint_as_float(x[3]), __uint_as_float(y[3]));
  }
}
// The residual of row r, group 4 jg + q (from column c): 16 bytes of bf16
// (raw[0]) or 32 of f32 (raw[0], raw[1]); zeros past the rows. Issued for
// several groups before any is used, so their latencies overlap.
__device__ __forceinline__ void ws_load_res(const WsArgs& g, int r, int c, uint4 (&raw)[2]) {
  raw[0] = raw[1] = make_uint4(0u, 0u, 0u, 0u);
  if (r >= g.M) return;
  const long o = (long)r * g.N + c;
  if (g.res_f32) {
    const uint4* p = reinterpret_cast<const uint4*>(static_cast<const float*>(g.res) + o);
    raw[0] = p[0];
    raw[1] = p[1];
  } else {
    raw[0] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.res) + o);
  }
}
// this lane's residual pairs of groups 4 jg + k (res[k]) from the quad's raw loads
__device__ __forceinline__ void ws_unpack_res(const WsArgs& g, const uint4 (&raw)[2], float2 (&res)[4], int q) {
  if (g.res_f32) {
    uint32_t x[4] = {raw[0].x, raw[0].z, raw[1].x, raw[1].z}, y[4] = {raw[0].y, raw[0].w, raw[1].y, raw[1].w};
    quad_transpose(x, q);
    quad_transpose(y, q);
#pragma unroll
    for (int k = 0; k < 4; ++k) res[k] = make_float2(__uint_as_float(x[k]), __uint_as_float(y[k]));
  } else {
    uint32_t x[4] = {raw[0].x, raw[0].y, raw[0].z, raw[0].w};
    quad_transpose(x, q);
#pragma unroll
    for (int k = 0; k < 4; ++k) res[k] = unpack_bf16x2(x[k]);
  }
}

// Rows r and r + 8 of this CTA's 256 residual columns into the L2 while the
// tile's main loop runs, a quad's 4 lanes taking a row's 128-byte lines in
// turn, so that the epilogue's loads do not wait on device memory.
__device__ __forceinline__ void ws_prefetch_res(const WsArgs& g, int r, int n0, int q) {
  const int es = g.res_f32 ? 4 : 2, lines = WS_BN * es / 128;
  const char* base = static_cast<const char*>(g.res);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (r + 8 * rr >= g.M) continue;
    const char* row = base + ((long)(r + 8 * rr) * g.N + n0) * es;
    for (int l = q; l < lines; l += 4) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + 128 * l));
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

// This CTA's row statistics {sum of row r, of row r + 8, sum of squared
// deviations from this half's mean of row r, of row r + 8}, held by every
// lane of the quad, into the peer's exchange buffer (a float4 per quad),
// the quad's first lane storing them and arriving on the peer's barrier;
// then the peer's from this CTA's buffer, once the peer's 64 quads are in.
__device__ __forceinline__ float4 ws_exchange(float4 own, float4* buf, uint64_t* bar, unsigned parity, uint32_t peer,
                                              int quad, int lane) {
  if (lane % 4 == 0) {
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(cluster_addr(smem_u32(buf + quad), peer)),
                 "f"(own.x), "f"(own.y), "f"(own.z), "f"(own.w)
                 : "memory");
    mbar_arrive_cluster(cluster_addr(smem_u32(bar), peer));
  }
  mbar_wait_acquire_cluster(bar, parity);
  return buf[quad];
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
// x (f32, if g.x) and out (bf16). `buf` is this tile's exchange buffer,
// `bar` its mbarrier.
__device__ __forceinline__ void ws_epilogue_ln(const WsArgs& g, float (&d)[128], int r0, int n0, float* buf,
                                               uint64_t* bar, unsigned parity, uint32_t peer, int lane) {
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
  const float4 p = ws_exchange(make_float4(s_lo, s_hi, q_lo, q_hi), reinterpret_cast<float4*>(buf), bar, parity,
                               peer, threadIdx.x / 4, lane);
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

// The persistent, warp-specialized kernel. WS_GELU / WS_GELU_ERF: block b
// takes tiles b, b + gridDim.x, ... of 128 x 256 (row-major over the tile
// grid). WS_LN: launched as clusters of two; cluster c takes row blocks c,
// c + clusters, ..., CTA rank r its columns [256 r, 256 r + 256).
template <int EPI>
__global__ void __launch_bounds__(WS_THREADS, 1) gemm_ws_kernel(const __grid_constant__ WsMaps maps, const WsArgs g) {
  constexpr bool LN = EPI == WS_LN;
  extern __shared__ __align__(128) unsigned char ws_smem[];
  const uint32_t raw = smem_u32(ws_smem);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;  // the same in both CTAs of a pair
  unsigned char* sm = ws_smem + pad;
  const uint32_t s0 = raw + pad;
  float* part = reinterpret_cast<float*>(sm + WS_STAGES * WS_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + WS_STAGES * WS_STAGE + WS_PART_BYTES);
  uint64_t* empty = full + WS_STAGES;
  uint64_t* xbar = empty + WS_STAGES;  // one per exchange buffer
  const int tid = threadIdx.x;
  const uint32_t rank = LN ? cluster_rank() : 0;
  const int first = LN ? blockIdx.x / 2 : blockIdx.x, stride = LN ? gridDim.x / 2 : gridDim.x;
  const int tn = LN ? 1 : g.N / WS_BN, n_tiles = tn * ((g.M + WS_BM - 1) / WS_BM), KT = g.K / WS_BK;

  if (tid == 0) {
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // each consumer warpgroup
    }
    if (LN)
      for (int i = 0; i < WS_NB; ++i) mbar_init(&xbar[i], 64);  // each quad of the peer's consumers
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (LN) {
    cluster_sync();  // the peer's barriers exist before any arrival reaches them
  } else {
    __syncthreads();
  }

  if (tid >= 256) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      int it = 0;  // this block's k-iterations so far
      for (int t = first; t < n_tiles; t += stride) {
        const int m0 = (t / tn) * WS_BM, n0 = LN ? (int)rank * WS_BN : (t % tn) * WS_BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % WS_STAGES;
          if (it >= WS_STAGES) mbar_wait(&empty[s], ((it / WS_STAGES) - 1) & 1);
          unsigned char* st = sm + s * WS_STAGE;
          mbar_expect_tx(&full[s], WS_STAGE);
          tma_load(st, &maps.a, &full[s], kt * WS_BK, m0, 0);
          tma_load(st + WS_A_BYTES, &maps.b, &full[s], kt * WS_BK, n0, 0);
        }
      }
      // every stage released: no copy or arrival is still on its way to
      // this CTA's barriers when it exits
      for (int j = 0; j < WS_STAGES; ++j, ++it)
        if (it >= WS_STAGES) mbar_wait(&empty[it % WS_STAGES], ((it / WS_STAGES) - 1) & 1);
    }
  } else {
    // consumer warpgroups 0 and 1: rows [64 wg, 64 wg + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid / 128, lt = tid % 128, lane = tid % 32;
    const int rt = wg * 64 + (lt / 32) * 16 + lane / 4;  // this thread's first row in the tile
    int it = 0, tc = 0;
    for (int t = first; t < n_tiles; t += stride, ++tc) {
      const int m0 = (t / tn) * WS_BM, n0 = LN ? (int)rank * WS_BN : (t % tn) * WS_BN;
      if constexpr (LN) ws_prefetch_res(g, m0 + rt, n0, lane % 4);
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % WS_STAGES;
        mbar_wait(&full[s], (it / WS_STAGES) & 1);
        const uint32_t a = s0 + s * WS_STAGE + wg * (WS_A_BYTES / 2), b = s0 + s * WS_STAGE + WS_A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WS_BK / 16; ++kk)
          // both operands K-major: 8-row groups 1024 bytes apart, k advanced
          // 32 bytes inside the swizzled row
          wgmma_m64n256k16<0>(d, sm90_desc(a + kk * 32, 16, 1024), sm90_desc(b + kk * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // the group of the previous k-tile is done
        if (kt > 0) ws_release(&empty[(it - 1) % WS_STAGES], lt);
      }
      wgmma_wait<0>();
      ws_release(&empty[(it - 1) % WS_STAGES], lt);
      if constexpr (LN) {
        const int nb = tc % WS_NB;
        ws_epilogue_ln(g, d, m0 + rt, n0, part + nb * 2 * WS_BM, xbar + nb, (tc / WS_NB) & 1, rank ^ 1u, lane);
      } else {
        ws_epilogue_gelu<EPI>(g, d, m0 + rt, n0, lane % 4);
      }
    }
  }
}

// The persistent launch: WS_GELU / WS_GELU_ERF min(tiles, SMs) blocks;
// WS_LN min(row blocks, SMs / 2) clusters of two.
template <int EPI>
cudaError_t gemm_ws(cudaStream_t st, const WsMaps& maps, const WsArgs& g) {
  static bool attr_set = false;
  if (!attr_set) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(gemm_ws_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(WS_SMEM)));
    attr_set = true;
  }
  const int rb = (g.M + WS_BM - 1) / WS_BM, sms = sm_count();
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(WS_THREADS);
  cfg.dynamicSmemBytes = WS_SMEM;
  cfg.stream = st;
  if (EPI == WS_LN) {
    const int pairs = rb < sms / 2 ? rb : sms / 2;
    cfg.gridDim = dim3(2 * pairs);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  } else {
    const int tiles = (g.N / WS_BN) * rb;
    cfg.gridDim = dim3(tiles < sms ? tiles : sms);
  }
  RETURN_IF_ERROR(cudaLaunchKernelEx(&cfg, gemm_ws_kernel<EPI>, maps, g));
  return cudaGetLastError();
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
    const int pairs = rb < sms / 2 ? rb : sms / 2, tiles = ln ? 2 * rb : (N / WS_BN) * rb;
    const long plan[7] = {1, WS_BM, WS_BN, ln ? 2 : 1, tiles, ln ? 2 * pairs : (tiles < sms ? tiles : sms),
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
