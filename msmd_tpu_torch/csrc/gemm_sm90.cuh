// The Hopper GEMM of the decoder's large products, hand-written for sm_90a:
// wgmma.mma_async m64n256k16 (bf16 in, f32 accumulation in registers) on
// operands in 128-byte-swizzled shared memory, with the decoder's fused
// epilogues. Included by decoder_common.cuh after the wmma GEMM, whose
// helpers (gelu_tanh, the EPI_* codes) it uses.
//
// It replaces the wmma tile (gemm_tile) for the four products of each
// decoder layer at the per-entry batch-48 shapes (R = Be * lq = 10656
// rows): QKV (N 1536, K 512, bf16 out with the q-column scale), FFN1
// (N 2048, K 512, tanh GELU), and the two residual products self-out
// (N 512, K 512) and FFN2 (N 512, K 2048), whose post-LayerNorm is folded
// into the epilogue. What bounds them: ~537 GFLOP of bf16 products per
// step against ~0.3 GB of operands, i.e. the tensor cores; only wgmma
// reaches their rate on Hopper (wmma/mma.sync run per warp and top out
// far lower).
//
// Design:
// - 256 threads = two warpgroups, no producer warp (K2's 256-thread
//   cooperative kernel calls the same tile function). One elected thread
//   starts the copies: TMA (cp.async.bulk.tensor) fills a ring of STAGES
//   k-tiles of 64 (one 128-byte row of bf16) in the 128-byte swizzle that
//   wgmma's descriptors read, and completes on one mbarrier per stage: A
//   (activations, K-major) as [BM][64], B (weights in the JAX (in, out)
//   layout, so N-major: wgmma's transposed-B mode) as BN/64 boxes of
//   [64 k][64 n]. TMA zero-fills rows past M. The tensor maps are built
//   on the host once per decoder call (make_decoder_maps: the A buffers
//   and each weight stack as (N, K, layers)) and reach the kernel as
//   __grid_constant__ parameters.
// - Two tile shapes, each warpgroup holding a 64 x 256 f32 accumulator
//   (128 registers a thread):
//     WGM = 2: 128 x 256, the warpgroups stacked in M (QKV, FFN1);
//     WGM = 1: 64 x 512, the warpgroups side by side in N, so one block
//       holds whole rows of an N = 512 product and can take the
//       LayerNorm of y = res + acc + bias in its epilogue (row sums
//       across the two warpgroups through shared memory): it writes x
//       (f32) and its bf16 copy xb, as ln_row does, in place over res.
// - Per k-tile: wait on its stage's mbarrier, four wgmma (k 16 each),
//   commit, wait until the previous group is done (one group stays in
//   flight), one block barrier, then the elected thread refills the
//   stage the previous group read, STAGES - 1 k-tiles ahead. A persistent
//   grid (min(tiles, SMs)) walks the tiles, and the ring runs on from one
//   tile of a block to its next, so the next tile's first k-tiles load
//   while the last one's epilogue runs.
// Each element's sum runs over K in the same order whatever block or
// launch computes it, so K1 and K2 (which call sm90_tiles_loop) agree bit for
// bit. Rounding points are the wmma GEMM's (decoder_common.cuh:107-111).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up through the CUDA runtime

namespace {

constexpr int SM90_THREADS = 256;    // two warpgroups
constexpr int SM90_BK = 64;          // k per stage: one 128-byte swizzle row of bf16
constexpr int SM90_MIN_ROWS = 1024;  // products with fewer rows (K4, small batches) keep the wmma tile
constexpr int EPI_RESID_LN = 6;      // x, xb = LayerNorm(res + (acc + bias)) * ln_scale + ln_bias
// EPI_RESID_LN, then on each row that is not a person row the identity
// band's cross step and its LayerNorm: x, xb = LayerNorm(x + ((0 + vmw) +
// bco)) * ln2_scale + ln2_bias; person rows (aux[row / lq] == row) keep
// the first LayerNorm, for the person attention's q
constexpr int EPI_RESID_LN_CROSS = 7;

template <int WGM>
struct Sm90Tile {
  static constexpr int WGN = 2 / WGM;
  static constexpr int BM = 64 * WGM, BN = 256 * WGN;
  static constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128, STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = WGM == 2 ? 4 : 3;
  static constexpr int PART = 4 * 64 * sizeof(float);  // LayerNorm row partials: [sum | sq][warpgroup][64]
  // the ring, 1024 bytes of slack to align it to the swizzle atom, the
  // partials and one mbarrier per stage
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 1024 + PART + STAGES * sizeof(uint64_t);
};

struct Sm90Args {
  const CUtensorMap* ta;  // A (M x K, K-major): box 64 x BM; an address in the kernel's parameters
  const CUtensorMap* tb;  // B (N x K x layers, the JAX (in, out) layout): box 64 x 64 x 1
  int layer;              // B's third coordinate
  const bf16* bias;   // N, or null
  const float* res;   // M x N f32 (EPI_RESID_LN; may alias C)
  void* C;            // M x N: bf16 (EPI_BF16, EPI_GELU) or f32 x (EPI_RESID_LN)
  bf16* Cb;           // EPI_RESID_LN: the bf16 copy of x
  const float* ln_scale;
  const float* ln_bias;
  int M, N, K;
  float scale;     // EPI_BF16: columns < scale_cols are multiplied by scale
  int scale_cols;  // before the bf16 cast
  // EPI_RESID_LN_CROSS: the layer's hoisted projected V-gather (M x N
  // bf16), wco's bias, the cross LayerNorm and the person rows
  const bf16* vmw = nullptr;
  const bf16* bco = nullptr;
  const float* ln2_scale = nullptr;
  const float* ln2_bias = nullptr;
  const int* aux = nullptr;
  int lq = 1;
};

// The products the Hopper GEMM takes: enough rows, K in whole stages, N in
// whole 256-column warpgroup tiles; the LayerNorm epilogue needs a block
// to hold whole rows, N == 512.
__host__ __device__ inline bool sm90_wide_ok(int M, int N, int K) {
  return M >= SM90_MIN_ROWS && K % SM90_BK == 0 && N % 256 == 0;
}
__host__ __device__ inline bool sm90_ln_ok(int M, int N, int K) {
  return M >= SM90_MIN_ROWS && K % SM90_BK == 0 && N == 512;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all >> 4), 128-byte swizzle
__device__ __forceinline__ uint64_t sm90_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// d (64 x 256 f32 of this warpgroup) += A (64 x 16, K-major) B (16 x 256):
// TRANS_B = 1 (imm-trans-b) reads B N-major (the JAX (in, out) layout, K1
// and K2), TRANS_B = 0 K-major (the nn.Linear (out, in) layout, gemm_ws.cuh)
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
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
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// The tile shape of an epilogue: whole 512-column rows for the LayerNorm
// fold, 128 x 256 otherwise.
template <int EPI>
struct Sm90Wgm {
  static constexpr int value = EPI == EPI_RESID_LN || EPI == EPI_RESID_LN_CROSS ? 1 : 2;
};

__host__ __device__ inline int sm90_tiles(int M, int N, int wgm) {
  const int bm = 64 * wgm, bn = 256 * (2 / wgm);
  return (N / bn) * ((M + bm - 1) / bm);
}

// The sums (s_lo, s_hi) of this thread's rows r0 and r0 + 8 over a 64 x
// 512 tile: over the quad, then the two warpgroups' halves through
// part[half][warpgroup][64 rows] (a block barrier). Reductions in turn
// take alternate halves of `part`, so a thread's writes never meet
// another's reads of the one before.
__device__ __forceinline__ float2 sm90_row_sum(float s_lo, float s_hi, int rt, int wgn, int lane, float* part) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s_lo += __shfl_xor_sync(0xffffffffu, s_lo, o);
    s_hi += __shfl_xor_sync(0xffffffffu, s_hi, o);
  }
  if (lane % 4 == 0) {
    part[wgn * 64 + rt] = s_lo;
    part[wgn * 64 + rt + 8] = s_hi;
  }
  __syncthreads();
  return make_float2(part[rt] + part[64 + rt], part[rt + 8] + part[64 + rt + 8]);
}

// The epilogue of the tile at (m0, n0) from this thread's accumulators:
// d[4j + {0, 1}] is (row r0, columns c + {0, 1}), d[4j + {2, 3}] row r0 + 8,
// with c = cb + 8 j. `part` holds the LayerNorm row partials ([sum | sq]
// [warpgroup][64 rows]).
template <int EPI, int WGM>
__device__ __forceinline__ void sm90_epilogue(const Sm90Args& g, float (&d)[128], int m0, int n0, float* part) {
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32, wwarp = (tid % 128) / 32;
  const int wgm = WGM == 2 ? wg : 0, wgn = WGM == 2 ? 0 : wg;
  const int rt = wgm * 64 + wwarp * 16 + lane / 4;  // row of the tile
  const int r0 = m0 + rt, r1 = r0 + 8;
  const int cb = n0 + wgn * 256 + 2 * (lane % 4);
  if constexpr (EPI == EPI_RESID_LN_CROSS) {
    // y = res + (acc + bias) in d, and its row statistics
    float s_lo = 0.0f, s_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = cb + 8 * j;
      float2 bj = make_float2(0.0f, 0.0f);
      if (g.bias) bj = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + c));
      float2 x0 = make_float2(0.0f, 0.0f), x1 = x0;
      if (r0 < g.M) x0 = *reinterpret_cast<const float2*>(g.res + (long)r0 * g.N + c);
      if (r1 < g.M) x1 = *reinterpret_cast<const float2*>(g.res + (long)r1 * g.N + c);
      d[4 * j] = x0.x + (d[4 * j] + bj.x);
      d[4 * j + 1] = x0.y + (d[4 * j + 1] + bj.y);
      d[4 * j + 2] = x1.x + (d[4 * j + 2] + bj.x);
      d[4 * j + 3] = x1.y + (d[4 * j + 3] + bj.y);
      s_lo += d[4 * j] + d[4 * j + 1];
      s_hi += d[4 * j + 2] + d[4 * j + 3];
    }
    float2 t = sm90_row_sum(s_lo, s_hi, rt, wgn, lane, part);
    const float mu_lo = t.x / g.N, mu_hi = t.y / g.N;
    float q_lo = 0.0f, q_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      q_lo += (d[4 * j] - mu_lo) * (d[4 * j] - mu_lo) + (d[4 * j + 1] - mu_lo) * (d[4 * j + 1] - mu_lo);
      q_hi += (d[4 * j + 2] - mu_hi) * (d[4 * j + 2] - mu_hi) + (d[4 * j + 3] - mu_hi) * (d[4 * j + 3] - mu_hi);
    }
    t = sm90_row_sum(q_lo, q_hi, rt, wgn, lane, part + 128);
    const float rs_lo = rsqrtf(t.x / g.N + 1e-5f), rs_hi = rsqrtf(t.y / g.N + 1e-5f);
    // The rows' cross values, in place of y in d (vmw and bco are read
    // once): the first LayerNorm's output o, and on a motion row, as
    // ln_row's cross step, o + ((0 + vmw) + bco); person rows (aux[row /
    // lq] == row) keep o.
    const bool p0 = r0 < g.M && g.aux[r0 / g.lq] == r0, p1 = r1 < g.M && g.aux[r1 / g.lq] == r1;
    s_lo = s_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = cb + 8 * j;
      const float2 gs = *reinterpret_cast<const float2*>(g.ln_scale + c);
      const float2 gb = *reinterpret_cast<const float2*>(g.ln_bias + c);
      const float2 bc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bco + c));
      float2 w0 = make_float2(0.0f, 0.0f), w1 = w0;
      if (r0 < g.M) w0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.vmw + (long)r0 * g.N + c));
      if (r1 < g.M) w1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.vmw + (long)r1 * g.N + c));
      const float o[4] = {(d[4 * j] - mu_lo) * rs_lo * gs.x + gb.x, (d[4 * j + 1] - mu_lo) * rs_lo * gs.y + gb.y,
                          (d[4 * j + 2] - mu_hi) * rs_hi * gs.x + gb.x, (d[4 * j + 3] - mu_hi) * rs_hi * gs.y + gb.y};
      d[4 * j] = p0 ? o[0] : o[0] + ((0.0f + w0.x) + bc.x);
      d[4 * j + 1] = p0 ? o[1] : o[1] + ((0.0f + w0.y) + bc.y);
      d[4 * j + 2] = p1 ? o[2] : o[2] + ((0.0f + w1.x) + bc.x);
      d[4 * j + 3] = p1 ? o[3] : o[3] + ((0.0f + w1.y) + bc.y);
      s_lo += d[4 * j] + d[4 * j + 1];
      s_hi += d[4 * j + 2] + d[4 * j + 3];
    }
    t = sm90_row_sum(s_lo, s_hi, rt, wgn, lane, part);
    const float m2_lo = t.x / g.N, m2_hi = t.y / g.N;
    q_lo = q_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      q_lo += (d[4 * j] - m2_lo) * (d[4 * j] - m2_lo) + (d[4 * j + 1] - m2_lo) * (d[4 * j + 1] - m2_lo);
      q_hi += (d[4 * j + 2] - m2_hi) * (d[4 * j + 2] - m2_hi) + (d[4 * j + 3] - m2_hi) * (d[4 * j + 3] - m2_hi);
    }
    t = sm90_row_sum(q_lo, q_hi, rt, wgn, lane, part + 128);
    const float r2_lo = rsqrtf(t.x / g.N + 1e-5f), r2_hi = rsqrtf(t.y / g.N + 1e-5f);
    float* x = static_cast<float*>(g.C);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = cb + 8 * j;
      const float2 gs = *reinterpret_cast<const float2*>(g.ln2_scale + c);
      const float2 gb = *reinterpret_cast<const float2*>(g.ln2_bias + c);
      if (r0 < g.M) {
        const float2 o = p0 ? make_float2(d[4 * j], d[4 * j + 1])
                            : make_float2((d[4 * j] - m2_lo) * r2_lo * gs.x + gb.x,
                                          (d[4 * j + 1] - m2_lo) * r2_lo * gs.y + gb.y);
        *reinterpret_cast<float2*>(x + (long)r0 * g.N + c) = o;
        *reinterpret_cast<__nv_bfloat162*>(g.Cb + (long)r0 * g.N + c) = __floats2bfloat162_rn(o.x, o.y);
      }
      if (r1 < g.M) {
        const float2 o = p1 ? make_float2(d[4 * j + 2], d[4 * j + 3])
                            : make_float2((d[4 * j + 2] - m2_hi) * r2_hi * gs.x + gb.x,
                                          (d[4 * j + 3] - m2_hi) * r2_hi * gs.y + gb.y);
        *reinterpret_cast<float2*>(x + (long)r1 * g.N + c) = o;
        *reinterpret_cast<__nv_bfloat162*>(g.Cb + (long)r1 * g.N + c) = __floats2bfloat162_rn(o.x, o.y);
      }
    }
  } else if constexpr (EPI == EPI_RESID_LN) {
    float s_lo = 0.0f, s_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = cb + 8 * j;
      float2 bj = make_float2(0.0f, 0.0f);
      if (g.bias) bj = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + c));
      float2 x0 = make_float2(0.0f, 0.0f), x1 = x0;
      if (r0 < g.M) x0 = *reinterpret_cast<const float2*>(g.res + (long)r0 * g.N + c);
      if (r1 < g.M) x1 = *reinterpret_cast<const float2*>(g.res + (long)r1 * g.N + c);
      d[4 * j] = x0.x + (d[4 * j] + bj.x);
      d[4 * j + 1] = x0.y + (d[4 * j + 1] + bj.y);
      d[4 * j + 2] = x1.x + (d[4 * j + 2] + bj.x);
      d[4 * j + 3] = x1.y + (d[4 * j + 3] + bj.y);
      s_lo += d[4 * j] + d[4 * j + 1];
      s_hi += d[4 * j + 2] + d[4 * j + 3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s_lo += __shfl_xor_sync(0xffffffffu, s_lo, o);
      s_hi += __shfl_xor_sync(0xffffffffu, s_hi, o);
    }
    if (lane % 4 == 0) {
      part[wgn * 64 + rt] = s_lo;
      part[wgn * 64 + rt + 8] = s_hi;
    }
    __syncthreads();
    const float mu_lo = (part[rt] + part[64 + rt]) / g.N, mu_hi = (part[rt + 8] + part[64 + rt + 8]) / g.N;
    float q_lo = 0.0f, q_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      q_lo += (d[4 * j] - mu_lo) * (d[4 * j] - mu_lo) + (d[4 * j + 1] - mu_lo) * (d[4 * j + 1] - mu_lo);
      q_hi += (d[4 * j + 2] - mu_hi) * (d[4 * j + 2] - mu_hi) + (d[4 * j + 3] - mu_hi) * (d[4 * j + 3] - mu_hi);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      q_lo += __shfl_xor_sync(0xffffffffu, q_lo, o);
      q_hi += __shfl_xor_sync(0xffffffffu, q_hi, o);
    }
    if (lane % 4 == 0) {
      part[128 + wgn * 64 + rt] = q_lo;
      part[128 + wgn * 64 + rt + 8] = q_hi;
    }
    __syncthreads();
    const float rs_lo = rsqrtf((part[128 + rt] + part[192 + rt]) / g.N + 1e-5f);
    const float rs_hi = rsqrtf((part[128 + rt + 8] + part[192 + rt + 8]) / g.N + 1e-5f);
    float* x = static_cast<float*>(g.C);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = cb + 8 * j;
      const float2 gs = *reinterpret_cast<const float2*>(g.ln_scale + c);
      const float2 gb = *reinterpret_cast<const float2*>(g.ln_bias + c);
      if (r0 < g.M) {
        const float2 o = make_float2((d[4 * j] - mu_lo) * rs_lo * gs.x + gb.x,
                                     (d[4 * j + 1] - mu_lo) * rs_lo * gs.y + gb.y);
        *reinterpret_cast<float2*>(x + (long)r0 * g.N + c) = o;
        *reinterpret_cast<__nv_bfloat162*>(g.Cb + (long)r0 * g.N + c) = __floats2bfloat162_rn(o.x, o.y);
      }
      if (r1 < g.M) {
        const float2 o = make_float2((d[4 * j + 2] - mu_hi) * rs_hi * gs.x + gb.x,
                                     (d[4 * j + 3] - mu_hi) * rs_hi * gs.y + gb.y);
        *reinterpret_cast<float2*>(x + (long)r1 * g.N + c) = o;
        *reinterpret_cast<__nv_bfloat162*>(g.Cb + (long)r1 * g.N + c) = __floats2bfloat162_rn(o.x, o.y);
      }
    }
  } else {
    bf16* C = static_cast<bf16*>(g.C);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = cb + 8 * j;
      float2 bj = make_float2(0.0f, 0.0f);
      if (g.bias) bj = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + c));
      float v[4] = {d[4 * j] + bj.x, d[4 * j + 1] + bj.y, d[4 * j + 2] + bj.x, d[4 * j + 3] + bj.y};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (EPI == EPI_BF16 && c + (t & 1) < g.scale_cols) v[t] *= g.scale;
        if (EPI == EPI_GELU) v[t] = gelu_tanh_fast(v[t]);
      }
      if (r0 < g.M) *reinterpret_cast<__nv_bfloat162*>(C + (long)r0 * g.N + c) = __floats2bfloat162_rn(v[0], v[1]);
      if (r1 < g.M) *reinterpret_cast<__nv_bfloat162*>(C + (long)r1 * g.N + c) = __floats2bfloat162_rn(v[2], v[3]);
    }
  }
}

// Every tile of one product by the blocks of the grid in turn (tile
// blockIdx.x, then + gridDim.x, ...: the persistent launch below, or K2's
// cooperative grid), all SM90_THREADS threads of the block, in `smem_raw`
// (Sm90Tile::SMEM bytes, any 16-byte alignment). The ring runs on across
// the block's tiles: the k-tiles of its next tile are in flight while
// the epilogue of the last one runs.
template <int EPI>
__device__ __forceinline__ void sm90_tiles_loop(const Sm90Args& g, unsigned char* smem_raw) {
  constexpr int WGM = Sm90Wgm<EPI>::value;
  using T = Sm90Tile<WGM>;
  const int tn = g.N / T::BN, n = sm90_tiles(g.M, g.N, WGM), KT = g.K / SM90_BK;
  if (static_cast<int>(blockIdx.x) >= n) return;  // the whole block: no tile here
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* sm = smem_raw + pad;  // the ring, aligned to the 1024-byte swizzle atom
  const uint32_t s0 = raw + pad;
  float* part = reinterpret_cast<float*>(sm + T::STAGES * T::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + T::STAGES * T::STAGE + T::PART);
  const int tid = threadIdx.x, wg = tid / 128;
  const int wgm = WGM == 2 ? wg : 0, wgn = WGM == 2 ? 0 : wg;
  __syncthreads();  // K2's previous phase is done with the shared memory
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // by the elected thread: this block's k-iteration j (its tile j / KT,
  // k-tile j % KT) into stage j % STAGES, if that tile exists
  auto load = [&](int j) {
    const int t = blockIdx.x + (j / KT) * gridDim.x;
    if (t >= n) return;
    const int kt = j % KT, stage = j % T::STAGES, m0 = (t / tn) * T::BM, n0 = (t % tn) * T::BN;
    unsigned char* a = sm + stage * T::STAGE;
    mbar_expect_tx(&full[stage], T::STAGE);
    tma_load(a, g.ta, &full[stage], kt * SM90_BK, m0, 0);
#pragma unroll
    for (int nb = 0; nb < T::BN / 64; ++nb)
      tma_load(a + T::A_BYTES + nb * (SM90_BK * 128), g.tb, &full[stage], n0 + nb * 64, kt * SM90_BK, g.layer);
  };
  if (tid == 0)
    for (int j = 0; j < T::STAGES - 1; ++j) load(j);

  int it = 0;  // this block's k-iterations so far
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      mbar_wait(&full[it % T::STAGES], (it / T::STAGES) & 1);
      const uint32_t st = s0 + (it % T::STAGES) * T::STAGE;
      const uint32_t a = st + wgm * 64 * 128, b = st + T::A_BYTES + wgn * 4 * (SM90_BK * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SM90_BK / 16; ++kk)
        // A: 8-row groups 1024 bytes apart, k advanced 32 bytes inside the
        // swizzled row; B: 64-column boxes SM90_BK * 128 bytes apart, 8-k
        // groups 1024 apart, k advanced 16 rows
        wgmma_m64n256k16(d, sm90_desc(a + kk * 32, 16, 1024), sm90_desc(b + kk * 2048, SM90_BK * 128, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // this warpgroup's previous group is done
      __syncthreads();  // ... and the other's: the stage it read is free
      if (tid == 0) load(it + T::STAGES - 1);
    }
    wgmma_wait<0>();
    sm90_epilogue<EPI, WGM>(g, d, (t / tn) * T::BM, (t % tn) * T::BN, part);
  }
  __syncthreads();  // every wait on the barriers is done
  if (tid == 0)
    for (int s = 0; s < T::STAGES; ++s) mbar_inval(&full[s]);
}

struct Sm90Maps {
  CUtensorMap a, b;
};

template <int EPI>
__global__ void __launch_bounds__(SM90_THREADS, 1) gemm_sm90_kernel(const __grid_constant__ Sm90Maps maps, Sm90Args g) {
  extern __shared__ __align__(128) unsigned char sm90_smem[];
  g.ta = &maps.a;
  g.tb = &maps.b;
  sm90_tiles_loop<EPI>(g, sm90_smem);
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n > 0 ? n : 1;
}

// The persistent launch: min(tiles, SMs) blocks of SM90_THREADS, one per SM
// (the ring takes most of an SM's shared memory), with the A and B tensor
// maps as parameters (g.ta and g.tb are set in the kernel). The shape must
// pass sm90_wide_ok (EPI_BF16, EPI_GELU) or sm90_ln_ok (EPI_RESID_LN).
template <int EPI>
cudaError_t gemm_sm90(cudaStream_t st, const CUtensorMap& a, const CUtensorMap& b, const Sm90Args& g) {
  constexpr int WGM = Sm90Wgm<EPI>::value;
  static bool attr_set = false;
  if (!attr_set) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(gemm_sm90_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Sm90Tile<WGM>::SMEM)));
    attr_set = true;
  }
  const int tiles = sm90_tiles(g.M, g.N, WGM), sms = sm_count();
  gemm_sm90_kernel<EPI><<<tiles < sms ? tiles : sms, SM90_THREADS, Sm90Tile<WGM>::SMEM, st>>>(Sm90Maps{a, b}, g);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// tensor maps (host)
// --------------------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the
// library links nothing beyond the CUDA runtime
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor (d0 innermost, then d1, then d2 layers, with row stride
// ld0 elements and layer stride ld1 elements) as a tensor map of boxes of
// 64 x box1 x 1 in the 128-byte swizzle; out-of-range rows read as zero.
inline cudaError_t make_map(CUtensorMap* map, const bf16* base, long d0, long d1, long d2, long ld0, long ld1,
                            int box1) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)ld0 * sizeof(bf16), (cuuint64_t)ld1 * sizeof(bf16)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box1, 1}, unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A (M x K, row stride lda) for a tile of `bm` rows.
inline cudaError_t make_a_map(CUtensorMap* map, const bf16* A, long lda, int M, int K, int bm) {
  return make_map(map, A, K, M, 1, lda, lda * M, bm);
}

// B stacked over `layers` (layers x K x N, the (in, out) layout).
inline cudaError_t make_b_map(CUtensorMap* map, const bf16* B, int K, int N, int layers) {
  return make_map(map, B, N, K, layers, N, (long)K * N, 64);
}

}  // namespace
