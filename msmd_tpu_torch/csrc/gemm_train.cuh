// The Hopper GEMM of K7, the training FFN block (ffn_train.cu), hand-written
// for sm_90a: gemm_ws.cuh's warp-specialized wgmma GEMM (a TMA producer
// warpgroup, two consumer warpgroups holding a 128 x 256 f32 tile, a ring of
// 64-deep stages with full and empty mbarriers), which K6 and K9 run, here
// with what the six products of K7's forward and backward need and K6's and
// K9's do not. Included by ffn_train.cu only; gemm_ws.cuh's kernels are
// untouched, this file uses its helpers (quad transpose, cluster exchange,
// the erf GELU).
//
// The products at the train step's shapes (R = 16 x 111 = 1776 rows, F 512,
// FFN 2048): each 3.7 GFLOP against 2-15 MB of operands, bound by the tensor
// cores.
//
//   forward    FFN1  x w1^T (R x FFN, K F)      TR_H     h = bf16(gelu(u) m1)
//              FFN2  h w2^T (R x F, K FFN)      TR_LN    out = LN(x + (acc + b2) m2)
//   backward   FFN1  recomputed                 TR_HG    h, and gp = m1 gelu'(u) (f32)
//              FFN2  recomputed                 TR_LN_BWD  the LayerNorm backward:
//                    dr (f32), dy = dr m2 (bf16), column partials of dy, gbar yhat, gbar
//              dh    dy w2 (R x FFN, K F)       TR_DU    du = acc gp (bf16), db1's partials
//              dx    du w1 (R x F, K FFN)       TR_DX    dx = bf16(dr + acc)
//              dW1   du^T x (FFN x F, K R)      TR_WGRAD bf16 dW1
//              dW2   dy^T h (F x FFN, K R)      TR_WGRAD bf16 dW2 (one grouped launch with dW1)
//
// Design:
// - Operands in any of the layouts the products give, read by TMA as they
//   lie: A K-major (activations, boxes of 64 k x 128 rows) or MN-major (du
//   and dy as the weight gradients' A: boxes of 64 m x 64 k, wgmma's
//   transposed-A mode); B K-major (the nn.Linear weights of FFN1 and FFN2:
//   boxes of 64 k x 256 rows) or N-major (w2 and w1 for dh and dx, x and h
//   for the weight gradients: four boxes of 64 n x 64 k, the transposed-B
//   mode, the layout K1's gemm_sm90.cuh reads its weights in). No operand is
//   copied or transposed in memory. TMA zero-fills past every edge, so K
//   (the rows, for the weight gradients) needs no multiple of 64.
// - One tile a CTA (no persistent loop): at these shapes every product has
//   few tiles, and they are spread over the SMs by splitting K.
//   - The N = 512 products (FFN2 in both passes, dx: 14 row blocks of two
//     256-column halves = 28 tiles) run as clusters of four CTAs, two column
//     halves x two K-slices of FFN / 2, 56 CTAs. Each consumer thread holds
//     two rows; after the main loop it stores its partial of the row the
//     other K-slice finishes into that CTA's shared memory
//     (st.shared::cluster, to the same thread there) and arrives on its
//     mbarrier, then adds the partial it receives to its own row (two terms:
//     the same bits in either order) and takes that row's epilogue, so every
//     warp of both CTAs takes part. The LayerNorm's row statistics cross the
//     two column halves of a K-slice as in gemm_ws.cuh (a float4 a quad into
//     the peer's buffer, Chan et al.'s combination); the LayerNorm
//     backward's sums of dyhat and dyhat yhat cross the same way.
//   - The weight gradients (32 tiles each, dW1 and dW2 in one launch, 128
//     CTAs) split their K, the rows, into two chunks of whole 64-row k-steps
//     run by a cluster of two, summed the same way and rounded to bf16 once.
//   - Column sums (db1, db2, dg, db) come from the epilogues as partial sums
//     of each warp's rows, summed in row order by a last pass
//     (ffn_train.cu). No atomics anywhere: two calls give the same bits.
// - Epilogues in an 8-column layout: a 4 x 4 transpose across each quad
//   (gemm_ws.cuh's) gives each thread 8 consecutive columns of a row, so
//   every global access is a 16- or 32-byte vector and a byte of dropout
//   keep bits covers them. Those bits (two Philox calls a byte) go to shared
//   memory before the epilogue: the consumers draw most of them while the
//   ring fills, the producer warpgroup's three warps that issue no copies
//   the rest during the main loop (PERF.md, PR 10: in the epilogue they
//   cost 2-3 us a masked product at 1776 rows).
// - The accumulators pass through an empty asm after the last
//   wgmma.wait_group (tr_fence_operands): otherwise the compiler may move
//   register-only uses above the wait, and ptxas serializes the wgmma.
// Rounding points: those of the wmma route in ffn_train.cu and the plain
// versions in ops/kernels/ffn_train.py.

#pragma once

#include "gemm_ws.cuh"

namespace {

// --------------------------------------------------------------------------
// Philox4x32-10 dropout bits
// --------------------------------------------------------------------------

__device__ __forceinline__ uint4 philox4x32_10(uint32_t k0, uint32_t k1, uint4 c) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u, W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the bits of columns 4g .. 4g + 3 of `row`
__device__ __forceinline__ uint4 mask_bits4(uint32_t seed, uint32_t salt, int row, int g) {
  return philox4x32_10(seed, salt, make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(row), 0u, 0u));
}

struct Dropout {
  const int* seed;  // device scalar
  uint32_t thr;     // keep iff bits >= thr; 0 keeps everything
  float scale;      // 1 / (1 - p), as the wrapper rounds it to f32
};

// the keep bits (bit t: column c0 + t) of 8 consecutive columns, c0 % 8 == 0
__device__ __forceinline__ uint32_t keep8(const Dropout& d, uint32_t seed, uint32_t salt, int row, int c0) {
  if (d.thr == 0u) return 0xFFu;
  const uint4 a = mask_bits4(seed, salt, row, c0 / 4), b = mask_bits4(seed, salt, row, c0 / 4 + 1);
  const uint32_t bits[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t k = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) k |= (bits[t] >= d.thr ? 1u : 0u) << t;
  return k;
}

// --------------------------------------------------------------------------
// the GEMM
// --------------------------------------------------------------------------

// d (64 x 256 f32 of this warpgroup) += A (64 x 16) B (16 x 256): TRANS_A = 1
// reads A MN-major, TRANS_B = 1 B N-major (imm-trans-a, imm-trans-b)
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_train(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// The accumulators as operands of an empty volatile asm: uses of d cannot
// move above the wgmma.wait_group before it (that asm has no operands), nor
// its zeroing below the wgmma.fence after it; without it ptxas serialized
// the wgmma of four of the seven epilogues (C7511).
__device__ __forceinline__ void tr_fence_operands(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The epilogues (see the table above).
enum { TR_H = 0, TR_HG = 1, TR_LN = 2, TR_LN_BWD = 3, TR_DU = 4, TR_DX = 5, TR_WGRAD = 6 };

// K split over a cluster: 2 column halves x 2 K-slices (the N = 512
// products), or 2 K-slices (the weight gradients)
__host__ __device__ constexpr int tr_cluster(int epi) {
  return epi == TR_LN || epi == TR_LN_BWD || epi == TR_DX ? 4 : (epi == TR_WGRAD ? 2 : 1);
}
__host__ __device__ constexpr bool tr_split(int epi) { return tr_cluster(epi) > 1; }
__host__ __device__ constexpr bool tr_masked(int epi) {
  return epi == TR_H || epi == TR_HG || epi == TR_LN || epi == TR_LN_BWD;
}
__host__ __device__ constexpr bool tr_trans_a(int epi) { return epi == TR_WGRAD; }
__host__ __device__ constexpr bool tr_trans_b(int epi) { return epi == TR_DU || epi == TR_DX || epi == TR_WGRAD; }

constexpr int TR_PART_BYTES = 128 * WS_BN * (int)sizeof(float) / 2;  // one of each thread's two rows of 128 x 256
constexpr int TR_XCH_BYTES = 2 * 64 * 16;                          // two exchanges of a float4 per quad
constexpr int TR_KEEP_BYTES = WS_BM * WS_BN / 8;                   // a tile's dropout keep bits
constexpr int TR_MASK_THREADS = 96;                                // the producer's warps 1-3 draw some
__host__ __device__ constexpr int tr_stages(int epi) { return tr_split(epi) ? 3 : WS_STAGES; }
// the ring, 1024 bytes of slack to align it to the swizzle atom, the split
// products' partial and exchange buffers, the keep bits, the mbarriers
// (full and empty a stage, the partial's, the two exchanges', the keep bits')
__host__ __device__ constexpr size_t tr_smem(int epi) {
  return (size_t)tr_stages(epi) * WS_STAGE + 1024 + (tr_split(epi) ? TR_PART_BYTES + TR_XCH_BYTES : 0) +
         (tr_masked(epi) ? TR_KEEP_BYTES : 0) + (2 * tr_stages(epi) + 4) * sizeof(uint64_t);
}

// One product: C (M x N) = A (M x K) B (K x N) with an epilogue. Arrays are
// row-major with N columns.
struct TrainProblem {
  int M, N, K;
  const bf16* bias;    // TR_H, TR_HG: b1; TR_LN, TR_LN_BWD: b2
  const bf16* xres;    // TR_LN, TR_LN_BWD: the residual x (M x N)
  const bf16* gbar;    // TR_LN_BWD: the incoming gradient (M x N)
  const float* gam;    // TR_LN, TR_LN_BWD
  const float* bet;    // TR_LN
  const float* fin;    // TR_DU: gp; TR_DX: dr (M x N)
  float* fout;         // TR_HG: gp; TR_LN_BWD: dr
  bf16* out;           // TR_H, TR_HG: h; TR_LN: out; TR_LN_BWD: dy; TR_DU: du; TR_DX: dx; TR_WGRAD: dW
  float* colpart;      // TR_LN_BWD: [3][colpart_rows][N] (dy, gbar yhat, gbar); TR_DU: [colpart_rows][N]
  int colpart_rows;    // a row a warp and row block: 8 (TR_DU: 16 rows a warp) or 16 (TR_LN_BWD: 8 rows)
  Dropout drop;
};

struct TrainMaps {
  CUtensorMap a[2];  // A of each problem: K-major boxes of 64 k x 128 rows, or MN-major 64 m x 64 k
  CUtensorMap b[2];  // B: K-major boxes of 64 k x 256 rows, or N-major 64 n x 64 k
};

struct TrainLaunch {
  TrainProblem p[2];  // the second only for TR_WGRAD (dW2 beside dW1)
  int blocks0;        // TR_WGRAD: the CTAs of the first problem
};

// The 8 values of 8 consecutive columns, n0 + 8 (4 jg + q) .. + 7, of one
// of this thread's rows, from accumulators in the wgmma layout: `acc[S j +
// o + e]` holds column n0 + 8 j + 2 q + e of the row (d, S = 4: o = 2 rr for
// row r0 + 8 rr; one row's 64 values, S = 2, o = 0). A quad transpose of
// four 8-column groups (the quad holds the same rows).
template <int S, int N>
__device__ __forceinline__ void tr_group(const float (&acc)[N], int jg, int o, int q, float (&v)[8]) {
  uint32_t x[4], y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = __float_as_uint(acc[S * (4 * jg + k) + o]);
    y[k] = __float_as_uint(acc[S * (4 * jg + k) + o + 1]);
  }
  quad_transpose(x, q);
  quad_transpose(y, q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(x[k]);
    v[2 * k + 1] = __uint_as_float(y[k]);
  }
}

__device__ __forceinline__ void load_bf16x8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = unpack_bf16x2(w[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load_f32x8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store_bf16x8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}
__device__ __forceinline__ void store_f32x8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// v (this lane's 8 columns c .. c + 7, each summed over this lane's rows)
// summed over the warp's 8 lanes of this lane's q, as a reduce-scatter: at
// each of the three steps a lane keeps half of its columns, adds its
// partner's half to them and hands over the other (7 shuffles); lane q + 4 i
// then holds the sum of column c + t, t = 4 (lane bit 4) + 2 (bit 3) + (bit 2),
// and stores it at p[t].
__device__ __forceinline__ void tr_col_partial(const float (&v)[8], float* p, int lane) {
  const bool h1 = lane & 16, h2 = lane & 8, h3 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (h1 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, h1 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (h2 ? a[i + 2] : a[i]) + __shfl_xor_sync(0xffffffffu, h2 ? a[i] : a[i + 2], 8);
  p[4 * h1 + 2 * h2 + h3] = (h3 ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, h3 ? b[0] : b[1], 4);
}

// The erf GELU and its derivative at u, through ws_gelu_erf's intrinsics:
// Phi = 0.5 (1 + erf(u / sqrt 2)), gelu = u Phi, gelu' = Phi + u phi(u), the
// Abramowitz & Stegun erf and phi sharing exp(-u^2 / 2).
__device__ __forceinline__ void tr_gelu(float u, float& g, float& gp) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f, a4 = -1.453152027f,
              a5 = 1.061405429f, p = 0.3275911f;
  const float z = u * 0.70710677f, az = fabsf(z);
  const float t = __fdividef(1.0f, 1.0f + p * az);
  const float poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t;
  const float ex = __expf(-az * az);
  const float e = 1.0f - poly * ex;  // erf(|z|)
  const float Phi = 0.5f * (1.0f + (z < 0.0f ? -e : e));
  g = u * Phi;
  gp = Phi + u * 0.3989422804014327f * ex;
}

// ---- the epilogues of whole 128 x 256 tiles (two rows a thread) ----

// FFN1 (TR_H, TR_HG): u = acc + b1, h = bf16(gelu(u) m1), gp = m1 gelu'(u);
// keep: m1's keep bits of row r0, column group n0 + 8 q (+ 256 a row, + 4 a
// group jg)
template <int EPI>
__device__ __forceinline__ void tr_epilogue_hidden(const TrainProblem& g, const float (&d)[128], int r0, int n0,
                                                   int q, const uint8_t* keep_bits) {
#pragma unroll
  for (int jg = 0; jg < 8; ++jg) {
    const int c = n0 + 8 * (4 * jg + q);
    float b[8];
    load_bf16x8(g.bias + c, b);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      float v[8];
      tr_group<4>(d, jg, 2 * rr, q, v);
      if (r >= g.M) continue;
      const uint32_t keep = keep_bits[256 * rr + 4 * jg];
      float h[8], gp[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float m = (keep >> t) & 1u ? g.drop.scale : 0.0f;
        float gl, gd;
        tr_gelu(v[t] + b[t], gl, gd);
        h[t] = gl * m;
        gp[t] = m * gd;
      }
      store_bf16x8(g.out + (long)r * g.N + c, h);
      if (EPI == TR_HG) store_f32x8(g.fout + (long)r * g.N + c, gp);
    }
    // no load of a later group above this group's stores: hoisting them all
    // spilled TR_H (504 bytes)
    asm volatile("" ::: "memory");
  }
}

// dh (TR_DU): du = acc gp, written bf16, and its column sums over each
// warp's 16 rows
__device__ __forceinline__ void tr_epilogue_du(const TrainProblem& g, const float (&d)[128], int r0, int n0, int q,
                                               int prow, int lane) {
#pragma unroll
  for (int jg = 0; jg < 8; ++jg) {
    const int c = n0 + 8 * (4 * jg + q);
    float cs[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) cs[t] = 0.0f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      float v[8];
      tr_group<4>(d, jg, 2 * rr, q, v);
      if (r >= g.M) continue;
      float gp[8];
      load_f32x8(g.fin + (long)r * g.N + c, gp);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        v[t] *= gp[t];
        cs[t] += v[t];
      }
      store_bf16x8(g.out + (long)r * g.N + c, v);
    }
    tr_col_partial(cs, g.colpart + (long)prow * g.N + c, lane);
  }
}

// ---- the epilogues of the split products: one row r a thread, its 256
// columns of this CTA's half in v[8 jg + t] (column n0 + 8 (4 jg + q) + t) ----

// dW (TR_WGRAD): bf16(acc); rows and columns in whole tiles
__device__ __forceinline__ void tr_epilogue_wgrad(const TrainProblem& g, const float (&v)[64], int r, int n0, int q) {
#pragma unroll
  for (int jg = 0; jg < 8; ++jg) {
    float o[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) o[t] = v[8 * jg + t];
    store_bf16x8(g.out + (long)r * g.N + n0 + 8 * (4 * jg + q), o);
  }
}

// dx (TR_DX): bf16(dr + acc)
__device__ __forceinline__ void tr_epilogue_dx(const TrainProblem& g, const float (&v)[64], int r, int n0, int q) {
  if (r >= g.M) return;
#pragma unroll
  for (int jg = 0; jg < 8; ++jg) {
    const int c = n0 + 8 * (4 * jg + q);
    float o[8];
    load_f32x8(g.fin + (long)r * g.N + c, o);
#pragma unroll
    for (int t = 0; t < 8; ++t) o[t] += v[8 * jg + t];
    store_bf16x8(g.out + (long)r * g.N + c, o);
  }
}

// FFN2 (TR_LN, TR_LN_BWD): y = f32(x) + (acc + b2) m2 in v, its row
// statistics over both halves (the column peer holds the other), then out =
// bf16(LN(y)) (TR_LN), or the LayerNorm backward (TR_LN_BWD): yhat, dyhat =
// gbar gamma, the sums of dyhat and dyhat yhat over both halves, dr = rs
// (dyhat - mean(dyhat) - yhat mean(dyhat yhat)), dy = dr m2; dr (f32) and dy
// (bf16) written, and the column sums of dy, gbar yhat and gbar over each
// warp's 8 rows.
template <int EPI>
__device__ __forceinline__ void tr_epilogue_ln(const TrainProblem& g, float (&v)[64], int r, int n0, int q, int prow,
                                               int lane, int quad, float4* xch, uint64_t* xbar, uint32_t peer,
                                               const uint8_t* keep_bits) {
  const bool in = r < g.M;
  uint32_t keep[8];  // m2's keep bits of each group (keep_bits: row r, column group n0 + 8 q, + 4 a group)
  float s = 0.0f;
#pragma unroll
  for (int jg = 0; jg < 8; ++jg) {
    const int c = n0 + 8 * (4 * jg + q);
    float b[8], x[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    load_bf16x8(g.bias + c, b);
    if (in) load_bf16x8(g.xres + (long)r * g.N + c, x);
    keep[jg] = keep_bits[4 * jg];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float& y = v[8 * jg + t];
      y = x[t] + (y + b[t]) * ((keep[jg] >> t) & 1u ? g.drop.scale : 0.0f);
      s += y;
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mh = s / (g.N / 2);  // this half's mean
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sq += (v[i] - mh) * (v[i] - mh);
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float4 ps = ws_exchange(make_float4(s, sq, 0.0f, 0.0f), xch, &xbar[0], 0u, peer, quad, lane);
  const float2 st = ws_row_stats(s, sq, ps.x, ps.y, g.N);

  if constexpr (EPI == TR_LN) {
    if (!in) return;
#pragma unroll
    for (int jg = 0; jg < 8; ++jg) {
      const int c = n0 + 8 * (4 * jg + q);
      float ga[8], be[8], o[8];
      load_f32x8(g.gam + c, ga);
      load_f32x8(g.bet + c, be);
#pragma unroll
      for (int t = 0; t < 8; ++t) o[t] = (v[8 * jg + t] - st.x) * st.y * ga[t] + be[t];
      store_bf16x8(g.out + (long)r * g.N + c, o);
    }
  } else {
    // yhat in v, and the sums of dyhat and dyhat yhat over this half
    float a = 0.0f, by = 0.0f;
#pragma unroll
    for (int jg = 0; jg < 8; ++jg) {
      const int c = n0 + 8 * (4 * jg + q);
      float ga[8], gb[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      load_f32x8(g.gam + c, ga);
      if (in) load_bf16x8(g.gbar + (long)r * g.N + c, gb);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float& yh = v[8 * jg + t];
        yh = (yh - st.x) * st.y;
        const float dyh = gb[t] * ga[t];
        a += dyh;
        by += dyh * yh;
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      by += __shfl_xor_sync(0xffffffffu, by, o);
    }
    const float4 pa = ws_exchange(make_float4(a, by, 0.0f, 0.0f), xch + 64, &xbar[1], 0u, peer, quad, lane);
    const float ma = (a + pa.x) / g.N, mb = (by + pa.y) / g.N;
    const long set = (long)g.colpart_rows * g.N;  // between the three column-sum arrays
#pragma unroll
    for (int jg = 0; jg < 8; ++jg) {
      const int c = n0 + 8 * (4 * jg + q);
      float ga[8], gb[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, dr[8], dy[8], gy[8];
      load_f32x8(g.gam + c, ga);
      if (in) load_bf16x8(g.gbar + (long)r * g.N + c, gb);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float yh = v[8 * jg + t];
        dr[t] = st.y * (gb[t] * ga[t] - ma - yh * mb);
        dy[t] = in ? dr[t] * ((keep[jg] >> t) & 1u ? g.drop.scale : 0.0f) : 0.0f;
        gy[t] = gb[t] * yh;
      }
      if (in) {
        store_f32x8(g.fout + (long)r * g.N + c, dr);
        store_bf16x8(g.out + (long)r * g.N + c, dy);
      }
      float* cp = g.colpart + (long)prow * g.N + c;
      tr_col_partial(dy, cp, lane);
      tr_col_partial(gy, cp + set, lane);
      tr_col_partial(gb, cp + 2 * set, lane);
    }
  }
}

// The kernel: one tile a CTA, 384 threads (two consumer warpgroups, then
// the producer warpgroup).
// - TR_H, TR_HG, TR_DU: block b takes tile b (row-major over the tile grid).
// - TR_LN, TR_LN_BWD, TR_DX: clusters of four; cluster c takes row block c,
//   CTA rank r its columns [256 (r & 1), + 256) and K-slice s = r >> 1.
// - TR_WGRAD: clusters of two; blocks [0, blocks0) problem 0, the rest
//   problem 1; within a problem cluster c takes tile c, CTA rank s K-slice s.
// A K-slice takes the first or the second half of K's 64-deep k-steps (the
// first the larger). Each consumer thread of a split product finishes its
// row r0 + 8 s and hands its other row's partial to the other K-slice's
// CTA, which finishes that one: every warp takes part in the epilogue.
template <int EPI>
__global__ void __launch_bounds__(WS_THREADS, 1)
    gemm_train_kernel(const __grid_constant__ TrainMaps maps, const __grid_constant__ TrainLaunch L) {
  constexpr bool SPLIT = tr_split(EPI), TA = tr_trans_a(EPI), TB = tr_trans_b(EPI);
  constexpr int CL = tr_cluster(EPI);
  constexpr bool MASKED = tr_masked(EPI);
  constexpr int STAGES = tr_stages(EPI);
  extern __shared__ __align__(128) unsigned char tr_smem_raw[];
  const uint32_t raw = smem_u32(tr_smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;  // the same in every CTA of a cluster
  unsigned char* sm = tr_smem_raw + pad;
  const uint32_t s0 = raw + pad;
  float4* part = reinterpret_cast<float4*>(sm + STAGES * WS_STAGE);                 // SPLIT: the received partial
  float4* xch = reinterpret_cast<float4*>(sm + STAGES * WS_STAGE + TR_PART_BYTES);  // SPLIT: the exchanges
  uint8_t* keep_bits = sm + STAGES * WS_STAGE + (SPLIT ? TR_PART_BYTES + TR_XCH_BYTES : 0);  // [tile row][group]
  uint64_t* full = reinterpret_cast<uint64_t*>(keep_bits + (MASKED ? TR_KEEP_BYTES : 0));
  uint64_t* empty = full + STAGES;
  uint64_t* pbar = empty + STAGES;  // the partial is in
  uint64_t* xbar = pbar + 1;        // the two exchanges
  uint64_t* kbar = xbar + 2;        // the keep bits are in
  const int tid = threadIdx.x;
  const int prob = EPI == TR_WGRAD && static_cast<int>(blockIdx.x) >= L.blocks0 ? 1 : 0;
  const TrainProblem& g = L.p[prob];
  const int KT = (g.K + WS_BK - 1) / WS_BK;
  const uint32_t rank = SPLIT ? cluster_rank() : 0u;
  const int slice = static_cast<int>(rank) / (CL > 1 ? CL / 2 : 1);  // SPLIT: this CTA's K-slice
  int m0, n0, kb, ke;
  if constexpr (SPLIT) {
    if constexpr (CL == 4) {
      m0 = (blockIdx.x / CL) * WS_BM;
      n0 = (rank & 1u) * WS_BN;
    } else {
      const int c = (blockIdx.x - (prob ? L.blocks0 : 0)) / CL, tn = g.N / WS_BN;
      m0 = (c / tn) * WS_BM;
      n0 = (c % tn) * WS_BN;
    }
    kb = slice ? (KT + 1) / 2 : 0;
    ke = slice ? KT : (KT + 1) / 2;
  } else {
    const int tn = g.N / WS_BN;
    m0 = (blockIdx.x / tn) * WS_BM;
    n0 = (blockIdx.x % tn) * WS_BN;
    kb = 0;
    ke = KT;
  }

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // each consumer warpgroup
    }
    if (SPLIT) {
      mbar_init(pbar, 256);     // each consumer thread of the other K-slice
      mbar_init(&xbar[0], 64);  // each quad of the column peer's consumers
      mbar_init(&xbar[1], 64);
    }
    if (MASKED) mbar_init(kbar, TR_MASK_THREADS + 256);  // the mask warps and the consumers
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (SPLIT) {
    cluster_sync();  // the peers' barriers exist before any arrival reaches them
  } else {
    __syncthreads();
  }

  // The dropout keep bits, 8 columns a byte, of the rows this CTA finishes
  // (all 128, or a split product's rows 16 k + 8 s + i) by index rho: the
  // consumers draw the first CONSUMER_ROWS before their first wgmma, while
  // the ring fills, the producer's warps 1-3 the rest during the main loop
  // (those three alone outlasted FFN1's 8 k-steps).
  constexpr int MASK_ROWS = SPLIT ? WS_BM / 2 : WS_BM, CONSUMER_ROWS = SPLIT ? 32 : 96;
  auto draw_keep_bits = [&](int i, int end, int step) {
    const uint32_t salt = EPI == TR_H || EPI == TR_HG ? 1u : 2u;
    const uint32_t seed = g.drop.thr ? static_cast<uint32_t>(*g.drop.seed) : 0u;
    for (; i < end; i += step) {
      const int rho = i / (WS_BN / 8), grp = i % (WS_BN / 8);
      const int row = SPLIT ? (rho >> 3) * 16 + slice * 8 + (rho & 7) : rho;
      keep_bits[row * (WS_BN / 8) + grp] = static_cast<uint8_t>(keep8(g.drop, seed, salt, m0 + row, n0 + 8 * grp));
    }
    mbar_arrive(kbar);
  };

  if (tid >= 256) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      for (int kt = kb, it = 0; kt < ke; ++kt, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        unsigned char* st = sm + s * WS_STAGE;
        const int k0 = kt * WS_BK;
        mbar_expect_tx(&full[s], WS_STAGE);
        if (TA) {  // two boxes of 64 m x 64 k
          tma_load(st, &maps.a[prob], &full[s], m0, k0, 0);
          tma_load(st + WS_A_BYTES / 2, &maps.a[prob], &full[s], m0 + 64, k0, 0);
        } else {
          tma_load(st, &maps.a[prob], &full[s], k0, m0, 0);
        }
        if (TB) {  // four boxes of 64 n x 64 k
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load(st + WS_A_BYTES + j * (WS_BK * 128), &maps.b[prob], &full[s], n0 + 64 * j, k0, 0);
        } else {
          tma_load(st + WS_A_BYTES, &maps.b[prob], &full[s], k0, n0, 0);
        }
      }
    } else if (MASKED && tid >= 256 + 32) {
      draw_keep_bits(CONSUMER_ROWS * (WS_BN / 8) + tid - (256 + 32), MASK_ROWS * (WS_BN / 8), TR_MASK_THREADS);
    }
    return;
  }

  // consumer warpgroups 0 and 1: rows [64 wg, 64 wg + 64) of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if constexpr (MASKED) draw_keep_bits(tid, CONSUMER_ROWS * (WS_BN / 8), 256);
  const int wg = tid / 128, lt = tid % 128, lane = tid % 32, q = lane % 4;
  const int rt = wg * 64 + (lt / 32) * 16 + lane / 4;  // this thread's first row in the tile
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  tr_fence_operands(d);
  for (int kt = kb, it = 0; kt < ke; ++kt, ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint32_t a = s0 + s * WS_STAGE + wg * (WS_A_BYTES / 2), b = s0 + s * WS_STAGE + WS_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WS_BK / 16; ++kk) {
      // K-major: 8-row groups 1024 bytes apart, k advanced 32 bytes inside
      // the swizzled row; MN-major: 64-wide boxes WS_BK * 128 bytes apart,
      // 8-k groups 1024 apart, k advanced 16 rows
      const uint64_t da = TA ? sm90_desc(a + kk * 2048, WS_BK * 128, 1024) : sm90_desc(a + kk * 32, 16, 1024);
      const uint64_t db = TB ? sm90_desc(b + kk * 2048, WS_BK * 128, 1024) : sm90_desc(b + kk * 32, 16, 1024);
      wgmma_train<TA ? 1 : 0, TB ? 1 : 0>(d, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group of the previous k-tile is done
    if (it > 0) ws_release(&empty[(it - 1) % STAGES], lt);
  }
  wgmma_wait<0>();
  tr_fence_operands(d);

  const int r0 = m0 + rt, warp = tid / 32;
  if constexpr (SPLIT) {
    // Row r0 + 8 s is this K-slice's, row r0 + 8 (1 - s) the other's: its
    // 64 values go to the same thread of rank r ^ 2, whose own values of
    // this row are added to them there (two terms: the same bits in either
    // order); acc[2 j + e] is then column n0 + 8 j + 2 q + e of row r.
    const int s = slice;
    const uint32_t kpeer = rank ^ static_cast<uint32_t>(CL / 2), dst = cluster_addr(smem_u32(part), kpeer);
#pragma unroll
    for (int j = 0; j < 32; j += 2)
      asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + 16 * ((j / 2) * 256 + tid)),
                   "f"(s ? d[4 * j] : d[4 * j + 2]), "f"(s ? d[4 * j + 1] : d[4 * j + 3]),
                   "f"(s ? d[4 * j + 4] : d[4 * j + 6]), "f"(s ? d[4 * j + 5] : d[4 * j + 7])
                   : "memory");
    mbar_arrive_cluster(cluster_addr(smem_u32(pbar), kpeer));
    mbar_wait_acquire_cluster(pbar, 0u);
    float acc[64];
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const float4 p = part[(j / 2) * 256 + tid];
      acc[2 * j] = (s ? d[4 * j + 2] : d[4 * j]) + p.x;
      acc[2 * j + 1] = (s ? d[4 * j + 3] : d[4 * j + 1]) + p.y;
      acc[2 * j + 2] = (s ? d[4 * j + 6] : d[4 * j + 4]) + p.z;
      acc[2 * j + 3] = (s ? d[4 * j + 7] : d[4 * j + 5]) + p.w;
    }
    float v[64];
#pragma unroll
    for (int jg = 0; jg < 8; ++jg) {
      float t8[8];
      tr_group<2>(acc, jg, 0, q, t8);
#pragma unroll
      for (int t = 0; t < 8; ++t) v[8 * jg + t] = t8[t];
    }
    const int r = r0 + 8 * s;
    if constexpr (EPI == TR_DX) {
      tr_epilogue_dx(g, v, r, n0, q);
    } else if constexpr (EPI == TR_WGRAD) {
      tr_epilogue_wgrad(g, v, r, n0, q);
    } else {
      const int prow = (m0 / WS_BM) * 16 + s * 8 + warp;  // this warp's row of the column partials
      mbar_wait(kbar, 0u);
      tr_epilogue_ln<EPI>(g, v, r, n0, q, prow, lane, tid / 4, xch, xbar, rank ^ 1u,
                          keep_bits + (rt + 8 * s) * (WS_BN / 8) + q);
    }
  } else if constexpr (EPI == TR_H || EPI == TR_HG) {
    mbar_wait(kbar, 0u);
    tr_epilogue_hidden<EPI>(g, d, r0, n0, q, keep_bits + rt * (WS_BN / 8) + q);
  } else {
    tr_epilogue_du(g, d, r0, n0, q, (m0 / WS_BM) * 8 + warp, lane);
  }
}

template <int EPI>
cudaError_t gemm_train(cudaStream_t st, const TrainMaps& maps, const TrainLaunch& L, int grid) {
  static bool attr_set = false;
  if (!attr_set) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(gemm_train_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(tr_smem(EPI))));
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(WS_THREADS);
  cfg.dynamicSmemBytes = tr_smem(EPI);
  cfg.stream = st;
  if (tr_split(EPI)) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = tr_cluster(EPI);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  RETURN_IF_ERROR(cudaLaunchKernelEx(&cfg, gemm_train_kernel<EPI>, maps, L));
  return cudaGetLastError();
}

}  // namespace
