// The Hopper GEMMs of the decoder's large products, hand-written for
// sm_90a: wgmma.mma_async m64n256k16 (bf16 in, f32 accumulation in
// registers) on operands that TMA copies into 128-byte-swizzled shared
// memory, with the decoder's fused epilogues. Included by
// decoder_common.cuh after the wmma GEMM, whose helpers (gelu_tanh_fast,
// the EPI_* codes) it uses. Two pipelines:
// - the warp-specialised one (ws_gemm_tiles): K1's four products
//   (gemm_sm90_kernel, below) and, through gemm_ws.cuh, K6's and K9's;
// - the 256-thread tile loop (sm90_tiles_loop) that K2 calls inside its
//   cooperative grid, and that msmd_gemm keeps as a named route.
//
// K1's products at the batch-48 shapes (R = Be * lq = 10656 rows, F 512,
// FFN 2048) and what bounds each on an H100 (989 TFLOP/s bf16, 3.35 TB/s):
//   QKV (EPI_BF16: N 1536, K 512, the q columns scaled)  16.8 GFLOP  17.0 us (operations)
//   FFN1 (EPI_GELU: N 2048, K 512, tanh GELU)             22.3 GFLOP  22.6 us (operations)
//   FFN2 + residual + LN3 (EPI_RESID_LN: N 512, K 2048)   22.3 GFLOP  22.6 us (operations)
//   self-out + residual + LN1, then on the motion rows the identity band's
//   cross step and its LayerNorm (EPI_RESID_LN_CROSS: N 512, K 512): 5.6
//   GFLOP against 77 MB (x f32 read and written, vmw, xb): 23 us (bytes).
// Only wgmma reaches the tensor cores' rate on Hopper (wmma and mma.sync
// run per warp and top out far lower).
//
// The warp-specialised pipeline (ws_gemm_tiles has the details):
// - 384 threads: a producer warpgroup, one of whose threads issues every
//   TMA copy, and two consumer warpgroups, each holding a 64 x 256 f32
//   accumulator (128 registers a thread; setmaxnreg moves registers from
//   the producer to them), stacked in M for a 128 x 256 tile. A ring of 4
//   stages of 64 k with full and empty mbarriers: no block barrier in the
//   main loop, up to two wgmma groups in flight a warpgroup. A persistent
//   grid, and the ring runs on from one tile of a block to its next.
// - K1's B is the weight in the JAX (in, out) layout, N-major: four TMA
//   boxes of 64 n x 64 k a stage, read in wgmma's transposed-B mode (no
//   weight is copied). K6's and K9's are in the nn.Linear layout. The
//   tensor maps are built on the host once per decoder call
//   (make_decoder_maps) and reach the kernels as __grid_constant__
//   parameters; TMA zero-fills rows past M.
// - QKV and FFN1: 128 x 256 tiles over the whole of N.
// - The two N = 512 LayerNorm products run as clusters of two CTAs, rank r
//   taking columns [256 r, 256 r + 256) of the same 128 rows, so B is read
//   once per 128 rows (85 operations a byte a stage copies, against 57
//   for the tile loop's 64 x 512 tiles). Each row reduction of the epilogue crosses the
//   pair through distributed shared memory: a quad's first lane st.async's
//   its half's row sums into the peer's buffer, completing bytes on the
//   peer's mbarrier (no fence).
// - Epilogues with 16-byte global accesses (a 4 x 4 transpose across each
//   quad), the residual and vmw rows prefetched into the L2 during the
//   main loop, the per-column LayerNorm parameters in a shared-memory table
//   filled once a CTA, and the person rows' output of EPI_RESID_LN_CROSS
//   written as soon as it is known: the epilogue then holds one form of
//   each row and does not spill.
// What still bounds EPI_RESID_LN_CROSS is its epilogue, run after the
// main loop of its tile (1.27 waves of 128-row blocks): PERF.md.
//
// The bits are the tile loop's, so K1 and K2 agree bit for bit and every
// K1 output is what it was on the tile loop: each accumulator element is
// the same m64n256k16 sequence over K in the same k16 order, on the same
// A rows and B columns; the epilogue evaluates each element's expression
// as sm90_epilogue does; each LayerNorm row sum is the thread's sum over
// the same 64 columns in the same order, then the quad's shuffle, then
// half 0 + half 1 (one addition, so which CTA holds which half does not
// matter); the division by N = 512 is the multiplication by 2^-9, the same
// correctly rounded real; the quad transpose moves bits only. Rounding
// points are the wmma GEMM's (decoder_common.cuh:107-111).

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

// The tile loop's tiles: 256 threads, two warpgroups each holding a
// 64 x 256 f32 accumulator, stacked in M (WGM = 2: 128 x 256, QKV and
// FFN1) or side by side in N (WGM = 1: 64 x 512, so one block holds whole
// rows of an N = 512 product and takes its LayerNorm, with the row sums
// crossing the warpgroups through shared memory).
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
// (Sm90Tile::SMEM bytes, any 16-byte alignment). No producer warp: one
// elected thread refills the stage the previous wgmma group read, after
// each k-tile's wait and block barrier. The ring runs on across the
// block's tiles: the k-tiles of its next tile are in flight while the
// epilogue of the last one runs.
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

// The tile loop as a kernel of its own: msmd_gemm's route 3, against
// which the card tests hold K1's products on the warp-specialised
// pipeline bit for bit.
template <int EPI>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    gemm_sm90_loop_kernel(const __grid_constant__ Sm90Maps maps, Sm90Args g) {
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

// The persistent launch of the loop: min(tiles, SMs) blocks of
// SM90_THREADS, one per SM (the ring takes most of an SM's shared memory),
// with the A and B tensor maps as parameters (g.ta and g.tb are set in the
// kernel). The shape must pass sm90_wide_ok (EPI_BF16, EPI_GELU) or
// sm90_ln_ok (EPI_RESID_LN, EPI_RESID_LN_CROSS).
template <int EPI>
cudaError_t gemm_sm90_loop(cudaStream_t st, const CUtensorMap& a, const CUtensorMap& b, const Sm90Args& g) {
  constexpr int WGM = Sm90Wgm<EPI>::value;
  static bool attr_set = false;
  if (!attr_set) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(gemm_sm90_loop_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Sm90Tile<WGM>::SMEM)));
    attr_set = true;
  }
  const int tiles = sm90_tiles(g.M, g.N, WGM), sms = sm_count();
  gemm_sm90_loop_kernel<EPI><<<tiles < sms ? tiles : sms, SM90_THREADS, Sm90Tile<WGM>::SMEM, st>>>(Sm90Maps{a, b}, g);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// the warp-specialised pipeline: K1's four products (gemm_sm90_kernel
// below), K6's and K9's (gemm_ws.cuh)
// --------------------------------------------------------------------------

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

// Blocks of the persistent launch: with `ln` min(row blocks, SMs / 2)
// clusters of two, else min(tiles, SMs) blocks of 128 x 256 tiles.
__host__ __device__ inline int ws_grid(bool ln, int M, int N, int sms) {
  const int rb = (M + WS_BM - 1) / WS_BM, tiles = (N / WS_BN) * rb;
  return ln ? 2 * (rb < sms / 2 ? rb : sms / 2) : (tiles < sms ? tiles : sms);
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

// A consumer warpgroup is done reading a stage: one arrival on its empty barrier.
__device__ __forceinline__ void ws_release(uint64_t* empty_bar, int thread_in_wg) {
  if (thread_in_wg == 0) mbar_arrive(empty_bar);
}

// The epilogues' global accesses go through the 4 lanes of a quad, which
// hold the same rows: in the accumulator layout lane q has columns 8 j + 2 q
// and 8 j + 2 q + 1 of 8-column group j; a 4 x 4 transpose over groups
// 4 jg .. 4 jg + 3 gives lane q the whole group 4 jg + q (16 bytes of bf16,
// 32 of f32), so each warp access is 8 rows x 64 contiguous bytes of 16-byte
// vectors, not 8 rows x 16 bytes of 4-byte words. Only bits move, so the
// values are those of the accumulator layout.

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

// Group 4 jg + q of a row, from p (the row's element of that group's first
// column; ok false past the rows: nothing is stored, zeros are loaded):
// bf16 stored from this lane's pairs v[k] of groups 4 jg + k, f32 from its
// pairs (x[k], y[k]), and 16 bytes of bf16 or 32 of f32 loaded raw. Loads
// are issued for several groups before any is used, so that their
// latencies overlap.
__device__ __forceinline__ void ws_store_bf16_at(bf16* p, bool ok, uint32_t (&v)[4], int q) {
  quad_transpose(v, q);
  if (ok) *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void ws_store_f32_at(float* p, bool ok, uint32_t (&x)[4], uint32_t (&y)[4], int q) {
  quad_transpose(x, q);
  quad_transpose(y, q);
  if (ok) {
    float4* o = reinterpret_cast<float4*>(p);
    o[0] = make_float4(__uint_as_float(x[0]), __uint_as_float(y[0]), __uint_as_float(x[1]), __uint_as_float(y[1]));
    o[1] = make_float4(__uint_as_float(x[2]), __uint_as_float(y[2]), __uint_as_float(x[3]), __uint_as_float(y[3]));
  }
}
__device__ __forceinline__ void ws_load_f32_at(const float* p, bool ok, uint4 (&raw)[2]) {
  raw[0] = raw[1] = make_uint4(0u, 0u, 0u, 0u);
  if (!ok) return;
  const uint4* v = reinterpret_cast<const uint4*>(p);
  raw[0] = v[0];
  raw[1] = v[1];
}
__device__ __forceinline__ uint4 ws_load_bf16_at(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}
// the same by row r and column c of an (M x N) matrix
__device__ __forceinline__ void ws_store_bf16(bf16* p, int M, int N, int r, int c, uint32_t (&v)[4], int q) {
  ws_store_bf16_at(p + (long)r * N + c, r < M, v, q);
}
__device__ __forceinline__ void ws_store_f32(float* p, int M, int N, int r, int c, uint32_t (&x)[4], uint32_t (&y)[4],
                                             int q) {
  ws_store_f32_at(p + (long)r * N + c, r < M, x, y, q);
}
__device__ __forceinline__ void ws_load_f32(const float* p, int M, int N, int r, int c, uint4 (&raw)[2]) {
  ws_load_f32_at(p + (long)r * N + c, r < M, raw);
}
__device__ __forceinline__ uint4 ws_load_bf16(const bf16* p, int M, int N, int r, int c) {
  return ws_load_bf16_at(p + (long)r * N + c, r < M);
}
// this lane's pairs of groups 4 jg + k (v[k]) from the quad's raw loads
__device__ __forceinline__ void ws_unpack_f32(const uint4 (&raw)[2], float2 (&v)[4], int q) {
  uint32_t x[4] = {raw[0].x, raw[0].z, raw[1].x, raw[1].z}, y[4] = {raw[0].y, raw[0].w, raw[1].y, raw[1].w};
  quad_transpose(x, q);
  quad_transpose(y, q);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = make_float2(__uint_as_float(x[k]), __uint_as_float(y[k]));
}
__device__ __forceinline__ void ws_unpack_bf16(uint4 raw, float2 (&v)[4], int q) {
  uint32_t x[4] = {raw.x, raw.y, raw.z, raw.w};
  quad_transpose(x, q);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = unpack_bf16x2(x[k]);
}

// Rows r and r + 8 of 256 columns from n0 of an (M x N) matrix of
// `es`-byte elements into the L2 while the tile's main loop runs, a quad's
// 4 lanes taking a row's 128-byte lines in turn, so that the epilogue's
// loads do not wait on device memory.
__device__ __forceinline__ void ws_prefetch_rows(const void* p, int es, int M, int N, int r, int n0, int q) {
  const int lines = WS_BN * es / 128;
  const char* base = static_cast<const char*>(p);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (r + 8 * rr >= M) continue;
    const char* row = base + ((long)(r + 8 * rr) * N + n0) * es;
    for (int l = q; l < lines; l += 4) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + 128 * l));
  }
}

// K7's exchange (gemm_train.cuh): this CTA's row statistics `own`, held
// by every lane of the quad, into the peer's exchange buffer (a float4 per
// quad), the quad's first lane storing them and arriving on the peer's
// barrier (64 arrivals) with release at cluster scope; then the peer's
// from this CTA's buffer, once the peer's 64 quads are in. WsPair below
// does the same without the fence.
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

// 16 bytes into the shared memory of a CTA of the cluster (dst, a
// shared::cluster address), completing as transaction bytes on its
// mbarrier (bar, the same): no fence, and no L1 invalidation on the
// reader's side.
__device__ __forceinline__ void st_async_f32x4(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// The exchanges of a two-CTA LayerNorm pair, which both CTAs make in the
// same order, taking the WS_NB buffers in turn: each quad's first lane
// sends its float4 into the peer's buffer by st.async, thread 0 arms this
// CTA's barrier for the peer's 64 quads, and every thread waits for them.
// Two buffers are enough: a CTA sends exchange e only after it got the
// peer's e - 1, which the peer sent after reading e - 2 out of the buffer
// that e takes (its values depend on what it read).
struct WsPair {
  float4* buf;    // WS_NB buffers of 64 quads
  uint64_t* bar;  // one mbarrier a buffer: one arrival (thread 0's) and 64 x 16 bytes
  uint32_t peer;  // the other CTA's rank
  int n;          // exchanges so far
  __device__ __forceinline__ float4 exchange(float4 own, int lane) {
    const int nb = n % WS_NB, quad = threadIdx.x / 4;
    const unsigned parity = (n / WS_NB) & 1;
    ++n;
    float4* b = buf + nb * 64;
    if (threadIdx.x == 0) mbar_expect_tx(bar + nb, 64 * sizeof(float4));
    if (lane % 4 == 0)
      st_async_f32x4(cluster_addr(smem_u32(b + quad), peer), own, cluster_addr(smem_u32(bar + nb), peer));
    mbar_wait(bar + nb, parity);
    return b[quad];
  }
};

// Every tile of one product on the warp-specialised pipeline, in a kernel
// of WS_THREADS threads with WS_SMEM bytes of dynamic shared memory at
// `smem_raw` (any 16-byte alignment):
// - consumer warpgroups 0 and 1 (setmaxnreg.inc to 232 registers) each
//   hold a 64 x 256 f32 accumulator, rows [64 wg, 64 wg + 64) of a
//   128 x 256 tile; producer warpgroup 2 (setmaxnreg.dec to 40), one of
//   whose threads issues every TMA copy;
// - a ring of WS_STAGES stages of 64 k (A 128 x 64, B 256 x 64: 48 KB),
//   each with a full mbarrier (the copies' bytes) and an empty one (an
//   arrival a consumer warpgroup once its wgmma have read the stage): no
//   block barrier in the main loop, and each warpgroup keeps up to two
//   wgmma groups in flight. The grid is persistent and the ring runs on
//   from one tile of a block to its next, so the next tile's loads overlap
//   the last one's epilogue.
// Epi gives the product:
//   Args          its arguments (M, N, K and what the epilogue reads);
//   LN            two-CTA clusters over N = 512, cluster c taking row
//                 blocks c, c + clusters, ..., CTA rank r its columns
//                 [256 r, 256 r + 256); else block b takes tiles b, b +
//                 gridDim.x, ... of 128 x 256, row-major over the tiles;
//   B_MN          B N-major, the JAX (in, out) layout (K1): four boxes of
//                 64 n x 64 k a stage, `layer` the map's third coordinate,
//                 read in wgmma's transposed-B mode; else K-major, the
//                 nn.Linear (out, in) layout (K6, K9): one box of 64 k x
//                 256 rows, read as A is;
//   A_BOX         rows of A's box: 128, or 64 (two boxes a stage, the same
//                 bytes in the same swizzled layout);
//   EXTRA         bytes of shared memory past WS_SMEM that the consumers
//                 fill once (setup(g, n0, cols), n0 the CTA's first column
//                 with LN) and the epilogue reads (`cols`);
//   prefetch(g, r, n0, q)   at the start of a tile, this thread's rows r
//                 and r + 8 (q = lane % 4);
//   epilogue(g, d, r0, n0, lane, pair, cols)   the tile from this thread's
//                 accumulators: d[4j + {0, 1}] (row r0, columns n0 + 8 j +
//                 2 q + {0, 1}), d[4j + {2, 3}] row r0 + 8; `pair` makes
//                 the LayerNorm pair's exchanges.
template <class Epi>
__device__ __forceinline__ void ws_gemm_tiles(const CUtensorMap* ta, const CUtensorMap* tb, int layer,
                                              const typename Epi::Args& g, unsigned char* smem_raw) {
  constexpr bool LN = Epi::LN;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;  // the same in both CTAs of a pair
  unsigned char* sm = smem_raw + pad;
  const uint32_t s0 = raw + pad;
  float4* part = reinterpret_cast<float4*>(sm + WS_STAGES * WS_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + WS_STAGES * WS_STAGE + WS_PART_BYTES);
  uint64_t* empty = full + WS_STAGES;
  uint64_t* xbar = empty + WS_STAGES;  // one per exchange buffer
  float* cols = reinterpret_cast<float*>(xbar + WS_NB);  // Epi::EXTRA bytes
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
      for (int i = 0; i < WS_NB; ++i) mbar_init(&xbar[i], 1);  // thread 0's arrival (and the peer's bytes)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (LN) {
    cluster_sync();  // the peer's barriers exist before any of its bytes reach them
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
          tma_load(st, ta, &full[s], kt * WS_BK, m0, 0);
          if constexpr (Epi::A_BOX < WS_BM) tma_load(st + WS_A_BYTES / 2, ta, &full[s], kt * WS_BK, m0 + 64, 0);
          if constexpr (Epi::B_MN) {
#pragma unroll
            for (int j = 0; j < WS_BN / 64; ++j)
              tma_load(st + WS_A_BYTES + j * (WS_BK * 128), tb, &full[s], n0 + 64 * j, kt * WS_BK, layer);
          } else {
            tma_load(st + WS_A_BYTES, tb, &full[s], kt * WS_BK, n0, 0);
          }
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
    WsPair pair{part, xbar, rank ^ 1u, 0};
    if constexpr (Epi::EXTRA > 0) {
      Epi::setup(g, (int)rank * WS_BN, cols);
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the two consumer warpgroups
    }
    int it = 0;
    for (int t = first; t < n_tiles; t += stride) {
      const int m0 = (t / tn) * WS_BM, n0 = LN ? (int)rank * WS_BN : (t % tn) * WS_BN;
      Epi::prefetch(g, m0 + rt, n0, lane % 4);
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % WS_STAGES;
        mbar_wait(&full[s], (it / WS_STAGES) & 1);
        const uint32_t a = s0 + s * WS_STAGE + wg * (WS_A_BYTES / 2), b = s0 + s * WS_STAGE + WS_A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WS_BK / 16; ++kk) {
          // A K-major: 8-row groups 1024 bytes apart, k advanced 32 bytes
          // inside the swizzled row. B N-major: 64-column boxes WS_BK * 128
          // bytes apart, 8-k groups 1024 apart, k advanced 16 rows; B
          // K-major: as A.
          if constexpr (Epi::B_MN) {
            wgmma_m64n256k16<1>(d, sm90_desc(a + kk * 32, 16, 1024), sm90_desc(b + kk * 2048, WS_BK * 128, 1024));
          } else {
            wgmma_m64n256k16<0>(d, sm90_desc(a + kk * 32, 16, 1024), sm90_desc(b + kk * 32, 16, 1024));
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group of the previous k-tile is done
        if (kt > 0) ws_release(&empty[(it - 1) % WS_STAGES], lt);
      }
      wgmma_wait<0>();
      ws_release(&empty[(it - 1) % WS_STAGES], lt);
      Epi::epilogue(g, d, m0 + rt, n0, lane, pair, cols);
    }
  }
}

// The persistent launch of a warp-specialised kernel (ws_grid's blocks,
// in clusters of two with `ln`, `smem` bytes of dynamic shared memory),
// its shared-memory limit raised at the first call.
template <class Maps, class Args>
cudaError_t ws_launch(void (*kernel)(Maps, Args), bool* attr_set, bool ln, size_t smem, cudaStream_t st,
                      const Maps& maps, const Args& g) {
  if (!*attr_set) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    *attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(ws_grid(ln, g.M, g.N, sm_count()));
  cfg.blockDim = dim3(WS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  if (ln) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  RETURN_IF_ERROR(cudaLaunchKernelEx(&cfg, kernel, maps, g));
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// K1's products on the warp-specialised pipeline
// --------------------------------------------------------------------------

// The sums (s_lo, s_hi) of this thread's rows r0 and r0 + 8 over a
// 128 x 512 row block, in sm90_row_sum's order: the thread's, over the
// quad, then the two 256-column halves, which here the pair's two CTAs
// hold (own + peer is half 0 + half 1: one addition, the same bits).
__device__ __forceinline__ float2 sm90_pair_sum(float s_lo, float s_hi, WsPair& pair, int lane) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s_lo += __shfl_xor_sync(0xffffffffu, s_lo, o);
    s_hi += __shfl_xor_sync(0xffffffffu, s_hi, o);
  }
  const float4 p = pair.exchange(make_float4(s_lo, s_hi, 0.0f, 0.0f), lane);
  return make_float2(s_lo + p.x, s_hi + p.y);
}

// K1's epilogues (sm90_epilogue's arithmetic, element for element and in
// its order) on a CTA's 128 x 256 tile, with 16-byte global accesses
// through the quad transpose and the rows they read prefetched into the
// L2 during the main loop. The LayerNorm products take their per-column
// parameters from a table in shared memory, filled once: the CTA's
// columns never change, and read from global memory in the epilogue the
// compiler hoisted them so far ahead that it spilled.
template <int EPI>
struct Sm90Epi {
  using Args = Sm90Args;
  static constexpr bool LN = EPI == EPI_RESID_LN || EPI == EPI_RESID_LN_CROSS, CROSS = EPI == EPI_RESID_LN_CROSS;
  static constexpr bool B_MN = true;
  static constexpr int A_BOX = LN ? 64 : WS_BM;  // sa and h are read through the 64-row maps K2 also reads
  // the column table: bias, ln_scale, ln_bias (and bco, ln2_scale, ln2_bias), f32 [param][256]
  enum { BIAS, LN_SCALE, LN_BIAS, BCO, LN2_SCALE, LN2_BIAS };
  static constexpr int EXTRA = LN ? (CROSS ? 6 : 3) * WS_BN * (int)sizeof(float) : 0;
  // 1 / N of the LayerNorm rows (N = 512, sm90_ln_ok): x * 2^-9 and x / 512
  // are the same correctly rounded real, so the same bits as
  // sm90_epilogue's division, without its slow path (a call, around which
  // the epilogue spilled); __fmul_rn keeps it out of an FMA
  static constexpr float INV_N = 1.0f / (2 * WS_BN);

  static __device__ __forceinline__ void setup(const Sm90Args& g, int n0, float* cols) {
    if constexpr (LN) {
      const int t = threadIdx.x, c = n0 + t;  // a consumer thread a column
      cols[BIAS * WS_BN + t] = g.bias ? __bfloat162float(g.bias[c]) : 0.0f;
      cols[LN_SCALE * WS_BN + t] = g.ln_scale[c];
      cols[LN_BIAS * WS_BN + t] = g.ln_bias[c];
      if constexpr (CROSS) {
        cols[BCO * WS_BN + t] = __bfloat162float(g.bco[c]);
        cols[LN2_SCALE * WS_BN + t] = g.ln2_scale[c];
        cols[LN2_BIAS * WS_BN + t] = g.ln2_bias[c];
      }
    }
  }
  // columns k, k + 1 (from the CTA's first) of parameter i
  static __device__ __forceinline__ float2 col2(const float* cols, int i, int k) {
    return *reinterpret_cast<const float2*>(cols + i * WS_BN + k);
  }

  static __device__ __forceinline__ void prefetch(const Sm90Args& g, int r, int n0, int q) {
    if constexpr (LN) ws_prefetch_rows(g.res, 4, g.M, g.N, r, n0, q);
    if constexpr (CROSS) ws_prefetch_rows(g.vmw, 2, g.M, g.N, r, n0, q);
  }

  // x and its bf16 copy xb (g.C, g.Cb) of this thread's rows (at element
  // offsets o0, o1 of the group 4 jg + q at jg = 0; written where w0, w1):
  // with NORM (y - m) * rs * scale + bias, y in d and scale, bias the column
  // table's parameters si, bi; else y itself
  template <bool NORM>
  static __device__ __forceinline__ void store_ln(const Sm90Args& g, const float (&d)[128], long o0, long o1,
                                                  bool w0, bool w1, int q, float m_lo, float rs_lo, float m_hi,
                                                  float rs_hi, const float* cols, int si, int bi) {
    float* x = static_cast<float*>(g.C);
#pragma unroll
    for (int jg = 0; jg < 8; ++jg) {
      uint32_t lo[4], hi[4], xl[4], yl[4], xh[4], yh[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * jg + k;
        float2 v0 = make_float2(d[4 * j], d[4 * j + 1]), v1 = make_float2(d[4 * j + 2], d[4 * j + 3]);
        if constexpr (NORM) {
          const float2 gs = col2(cols, si, 8 * j + 2 * q), gb = col2(cols, bi, 8 * j + 2 * q);
          v0 = make_float2((d[4 * j] - m_lo) * rs_lo * gs.x + gb.x, (d[4 * j + 1] - m_lo) * rs_lo * gs.y + gb.y);
          v1 = make_float2((d[4 * j + 2] - m_hi) * rs_hi * gs.x + gb.x,
                           (d[4 * j + 3] - m_hi) * rs_hi * gs.y + gb.y);
        }
        lo[k] = pack_bf16x2(v0.x, v0.y);
        hi[k] = pack_bf16x2(v1.x, v1.y);
        xl[k] = __float_as_uint(v0.x), yl[k] = __float_as_uint(v0.y);
        xh[k] = __float_as_uint(v1.x), yh[k] = __float_as_uint(v1.y);
      }
      ws_store_f32_at(x + o0 + 32 * jg, w0, xl, yl, q);
      ws_store_f32_at(x + o1 + 32 * jg, w1, xh, yh, q);
      ws_store_bf16_at(g.Cb + o0 + 32 * jg, w0, lo, q);
      ws_store_bf16_at(g.Cb + o1 + 32 * jg, w1, hi, q);
    }
  }

  static __device__ __forceinline__ void epilogue(const Sm90Args& g, float (&d)[128], int r0, int n0, int lane,
                                                  WsPair& pair, const float* cols) {
    const int q = lane % 4, r1 = r0 + 8;
    if constexpr (!LN) {
      bf16* C = static_cast<bf16*>(g.C);
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
          for (int t = 0; t < 4; ++t) {
            if (EPI == EPI_BF16 && c + (t & 1) < g.scale_cols) v[t] *= g.scale;
            if (EPI == EPI_GELU) v[t] = gelu_tanh_fast(v[t]);
          }
          lo[k] = pack_bf16x2(v[0], v[1]);
          hi[k] = pack_bf16x2(v[2], v[3]);
        }
        const int cg = n0 + 8 * (4 * jg + q);
        ws_store_bf16(C, g.M, g.N, r0, cg, lo, q);
        ws_store_bf16(C, g.M, g.N, r1, cg, hi, q);
      }
    } else {
      // element offsets of this thread's rows at its first group, which
      // advance by 32 a group of four (an immediate in every access)
      const long o0 = (long)r0 * g.N + n0 + 8 * q, o1 = o0 + 8L * g.N;
      const bool ok0 = r0 < g.M, ok1 = r1 < g.M;
      // y = res + (acc + bias) in d, and its row statistics
      float s_lo = 0.0f, s_hi = 0.0f;
#pragma unroll
      for (int jb = 0; jb < 8; jb += 4) {  // two batches of four groups' residual loads
        uint4 raw0[4][2], raw1[4][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          ws_load_f32_at(g.res + o0 + 32 * (jb + jj), ok0, raw0[jj]);
          ws_load_f32_at(g.res + o1 + 32 * (jb + jj), ok1, raw1[jj]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float2 x0[4], x1[4];
          ws_unpack_f32(raw0[jj], x0, q);
          ws_unpack_f32(raw1[jj], x1, q);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * (jb + jj) + k;
            const float2 bj = col2(cols, BIAS, 8 * j + 2 * q);
            d[4 * j] = x0[k].x + (d[4 * j] + bj.x);
            d[4 * j + 1] = x0[k].y + (d[4 * j + 1] + bj.y);
            d[4 * j + 2] = x1[k].x + (d[4 * j + 2] + bj.x);
            d[4 * j + 3] = x1[k].y + (d[4 * j + 3] + bj.y);
            s_lo += d[4 * j] + d[4 * j + 1];
            s_hi += d[4 * j + 2] + d[4 * j + 3];
          }
        }
      }
      float2 t = sm90_pair_sum(s_lo, s_hi, pair, lane);
      const float mu_lo = __fmul_rn(t.x, INV_N), mu_hi = __fmul_rn(t.y, INV_N);
      float q_lo = 0.0f, q_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        q_lo += (d[4 * j] - mu_lo) * (d[4 * j] - mu_lo) + (d[4 * j + 1] - mu_lo) * (d[4 * j + 1] - mu_lo);
        q_hi += (d[4 * j + 2] - mu_hi) * (d[4 * j + 2] - mu_hi) + (d[4 * j + 3] - mu_hi) * (d[4 * j + 3] - mu_hi);
      }
      t = sm90_pair_sum(q_lo, q_hi, pair, lane);
      const float rs_lo = rsqrtf(__fmul_rn(t.x, INV_N) + 1e-5f), rs_hi = rsqrtf(__fmul_rn(t.y, INV_N) + 1e-5f);
      if constexpr (!CROSS) {
        store_ln<true>(g, d, o0, o1, ok0, ok1, q, mu_lo, rs_lo, mu_hi, rs_hi, cols, LN_SCALE, LN_BIAS);
      } else {
        // The rows' cross values, in place of y in d: the first
        // LayerNorm's output o, and on a motion row o + ((0 + vmw) + bco);
        // person rows (aux[row / lq] == row) keep o.
        const bool p0 = ok0 && g.aux[r0 / g.lq] == r0, p1 = ok1 && g.aux[r1 / g.lq] == r1;
        s_lo = s_hi = 0.0f;
#pragma unroll
        for (int jb = 0; jb < 8; jb += 2) {  // four batches of two groups' vmw loads
          uint4 raw0[2], raw1[2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            raw0[jj] = ws_load_bf16_at(g.vmw + o0 + 32 * (jb + jj), ok0);
            raw1[jj] = ws_load_bf16_at(g.vmw + o1 + 32 * (jb + jj), ok1);
          }
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            float2 w0[4], w1[4];
            ws_unpack_bf16(raw0[jj], w0, q);
            ws_unpack_bf16(raw1[jj], w1, q);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int j = 4 * (jb + jj) + k, cc = 8 * j + 2 * q;
              const float2 gs = col2(cols, LN_SCALE, cc), gb = col2(cols, LN_BIAS, cc), bc = col2(cols, BCO, cc);
              const float o[4] = {(d[4 * j] - mu_lo) * rs_lo * gs.x + gb.x,
                                  (d[4 * j + 1] - mu_lo) * rs_lo * gs.y + gb.y,
                                  (d[4 * j + 2] - mu_hi) * rs_hi * gs.x + gb.x,
                                  (d[4 * j + 3] - mu_hi) * rs_hi * gs.y + gb.y};
              d[4 * j] = p0 ? o[0] : o[0] + ((0.0f + w0[k].x) + bc.x);
              d[4 * j + 1] = p0 ? o[1] : o[1] + ((0.0f + w0[k].y) + bc.y);
              d[4 * j + 2] = p1 ? o[2] : o[2] + ((0.0f + w1[k].x) + bc.x);
              d[4 * j + 3] = p1 ? o[3] : o[3] + ((0.0f + w1[k].y) + bc.y);
              s_lo += d[4 * j] + d[4 * j + 1];
              s_hi += d[4 * j + 2] + d[4 * j + 3];
            }
          }
        }
        // A person row's output is its first LayerNorm's (d now): written
        // here, so that no row needs both d and d - m2 below (keeping both
        // spilled). One row in lq; a warp holds 16 rows.
        if (__any_sync(0xffffffffu, p0 || p1))
          store_ln<false>(g, d, o0, o1, ok0 && p0, ok1 && p1, q, 0.0f, 0.0f, 0.0f, 0.0f, cols, 0, 0);
        t = sm90_pair_sum(s_lo, s_hi, pair, lane);
        const float m2_lo = __fmul_rn(t.x, INV_N), m2_hi = __fmul_rn(t.y, INV_N);
        q_lo = q_hi = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          q_lo += (d[4 * j] - m2_lo) * (d[4 * j] - m2_lo) + (d[4 * j + 1] - m2_lo) * (d[4 * j + 1] - m2_lo);
          q_hi += (d[4 * j + 2] - m2_hi) * (d[4 * j + 2] - m2_hi) + (d[4 * j + 3] - m2_hi) * (d[4 * j + 3] - m2_hi);
        }
        t = sm90_pair_sum(q_lo, q_hi, pair, lane);
        const float r2_lo = rsqrtf(__fmul_rn(t.x, INV_N) + 1e-5f), r2_hi = rsqrtf(__fmul_rn(t.y, INV_N) + 1e-5f);
        store_ln<true>(g, d, o0, o1, ok0 && !p0, ok1 && !p1, q, m2_lo, r2_lo, m2_hi, r2_hi, cols, LN2_SCALE, LN2_BIAS);
      }
    }
  }
};

// K1's products: the warp-specialised pipeline with K1's weight layout
// and epilogues.
template <int EPI>
__global__ void __launch_bounds__(WS_THREADS, 1) gemm_sm90_kernel(const __grid_constant__ Sm90Maps maps, Sm90Args g) {
  extern __shared__ __align__(128) unsigned char sm90_ws_smem[];
  ws_gemm_tiles<Sm90Epi<EPI>>(&maps.a, &maps.b, g.layer, g, sm90_ws_smem);
}

// One of K1's products on the warp-specialised pipeline: A's map with
// boxes of 128 rows (EPI_BF16, EPI_GELU; the shape passes sm90_wide_ok) or
// 64 (EPI_RESID_LN, EPI_RESID_LN_CROSS, as two-CTA clusters; sm90_ln_ok),
// B's (make_b_map) with g.layer its layer.
template <int EPI>
cudaError_t gemm_sm90(cudaStream_t st, const CUtensorMap& a, const CUtensorMap& b, const Sm90Args& g) {
  static bool attr_set = false;
  return ws_launch(gemm_sm90_kernel<EPI>, &attr_set, Sm90Epi<EPI>::LN, WS_SMEM + Sm90Epi<EPI>::EXTRA, st,
                   Sm90Maps{a, b}, g);
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
