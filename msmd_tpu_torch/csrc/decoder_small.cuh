// The small-row persistent decoder stack: all L layers of one DDPM sampler
// step as phases of ONE cooperative launch, for the row counts at which
// every product of the chained decoder (decoder_common.cuh::decoder_layers,
// K1's flat-mask chain of earlier PRs) runs below SM90_MIN_ROWS on a few
// dozen blocks. Shared by K3 (sampler.cu: two CFG entries of lq = 111, 222
// rows, the per-entry identity band with K3's f32 cross output) and K1's
// flat-mask mode (decoder.cu: the identity band through the person mask at
// Be = 4, 444 rows, or the full masked cross at Be = 2).
//
// Why: at 222-444 rows a step is ~12-25 GFLOP and ~60 MB of bf16 weights
// (more than the 50 MB L2), so its bound is ~20 us, but the chain of ~90
// launches a step on grids of 2-64 blocks took 1.7-2.1 ms. Here the grid is
// exactly the blocks the card holds at once (occupancy x SMs, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor at the kernel's fixed
// dynamic shared memory), and each phase hands its work items to the blocks
// in a strided loop, with a grid-wide barrier (cooperative_groups
// this_grid().sync()) between phases:
//
//   QKV | self-attention | self-out (split-K) | LN1 | cross q (split-K) |
//   person or cross attention | wco (split-K) | cross LN | FFN1 + GELU |
//   FFN2 (split-K) | LN3
//
// - Work split: products are cut into 64-row x 64-column tiles (32-row
//   ones for the person rows' products) and the N = F products into a
//   deterministic split-K: each of S slices of K writes its f32 partial to
//   its own slot of a workspace, and the consumer sums the S slots in slot
//   order (the next LayerNorm, the attention's q load, K3's epilogue). No
//   float atomics: two calls give the same bits. The split doubles while
//   the items still fit in one round of the grid and K divides (plan_gemm,
//   mirrored by ops/kernels/small_stack.py): a tile's time is mostly its
//   loads and latency, so one round of larger tiles beats two of smaller.
// - The products whose A rows are not gathered run on a wgmma m64n64k16
//   tile fed by TMA (a 512-deep slice of A and B in flight at once, the
//   two warpgroups on alternate k-steps); a wmma tile on a cp.async ring,
//   its loads and its latency-bound chain of wmma products both slower,
//   took about twice as long a phase on the card. The gathered rows'
//   products (the 2-4 person rows, K3's motion decoder over the tail rows)
//   keep the wmma tile.
// - The weight stream: each layer's ~7.3 MB of weights come from HBM
//   (the step's 59 MB exceed the 50 MB L2). A bulk L2 prefetch of the
//   next phases' weights, issued by every block a few phases ahead, made
//   the step slower on the card and is not used.
// - Rounding is the chained decoder's: bf16 left operands, f32 sums, the
//   bias added to the summed product, q scaled after its bias then cast,
//   the bf16 fast softmax exp(clamp(s - 20, -80, 60)) with the fully
//   masked 64-key blocks skipped, tanh-GELU, and the cross output rounded
//   per SmallMode (bf16 for K1's band, f32 for K3, the gathered rows'
//   product over every row for K4). Only the order of f32
//   sums differs from the chain (split-K, the two warpgroups' k-steps, the
//   masked attention's two key halves, the block-wide LayerNorm sums).
//
// The per-entry self-attention item is one 16-row query tile of
// self_attn_block's computation; the masked attention item is 64 query
// rows of the flat chain's masked_attn_kernel, now with its scores in
// registers (mma.sync) as self_attn_block holds them; the decoder_common.cuh
// functions that K1 per-entry, K2 and K4 run are not changed.

#pragma once

#include <cooperative_groups.h>

#include "decoder_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SMALL_THREADS = 256;   // 8 warps
// One 256-thread block an SM: two (at 128 registers) spilled and ran
// slower on the card.
constexpr int SMALL_MIN_BLOCKS = 1;
// the wmma tile (the gathered person and motion rows' products): a 4-deep
// cp.async ring of 64-deep k-steps, A and B stage rows both 72 wide
constexpr int SB_BN = 64, SB_BK = 64, SB_STAGES = 4, SB_LD = SB_BK + 8;
// the wgmma tile (every other product): 64 x 64, an 8-deep TMA ring of
// 64-deep k-steps (a 64 x 64 box of A and one of B, 16 KB), so a 512-deep
// slice is in flight at once
constexpr int WG_STAGES = 8, WG_STAGE = 2 * 64 * 128;

constexpr size_t wg_smem_bytes() {
  return (size_t)WG_STAGES * WG_STAGE + 1024 + 128 * 32 * sizeof(float) + WG_STAGES * sizeof(uint64_t);
}

template <int BM>
constexpr size_t sb_smem_bytes() {
  return (size_t)SB_STAGES * (BM + SB_BK) * SB_LD * sizeof(bf16) + (SMALL_THREADS / 32) * 16 * C_LD * sizeof(float);
}

// the flat mode's masked attention: 64 query rows a block, 64 keys a step
constexpr float MASK_FLOOR = -1e29f;  // scores at or below are structural masks
constexpr int MA_BQ = 64, MA_BK = 64;

// Q, two groups' two K and V buffers (all [64][64] bf16, swizzled), group
// 1's partial sums and row sums, the live key blocks
constexpr size_t masked_attn_smem_bytes() {
  return (size_t)MA_BQ * 128 + (size_t)2 * 2 * 2 * MA_BK * 128 + (size_t)MA_BQ * DH * sizeof(float) +
         MA_BQ * sizeof(float) + (MAX_LM + 1) * sizeof(int);
}

// one 16-row query tile of the per-entry self-attention: Q (16 rows), K, V
constexpr size_t qtile_smem_bytes() { return (size_t)(16 + 2 * ((MAX_LM + 15) / 16 * 16)) * 128; }

constexpr int PA_KEYS = 128;  // memory rows a person-attention block stages at a time

// the person-attention block: K and V chunks, q, numerators, 4 x DH partial outputs, 8 sums
constexpr size_t person_smem_bytes() { return (size_t)2 * PA_KEYS * DH * 2 + (DH + PA_KEYS + 4 * DH + 8) * 4; }

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// Every phase's shared memory, fixed so that the occupancy (and the grid)
// does not depend on the shapes; K3's prologue and epilogue rows check
// theirs against it.
constexpr size_t SMALL_SMEM =
    cmax(cmax(cmax(sb_smem_bytes<64>(), wg_smem_bytes()), masked_attn_smem_bytes()),
         cmax(qtile_smem_bytes(), person_smem_bytes()));

// SMALL_ENTRY: K3's per-entry band with its f32 cross output (the
// person rows' out projection scattered onto the hoisted vmw);
// SMALL_ENTRY_GATHER: K4's, [bf16(person output) | memory V rows] @ wco
// over every row; the flat modes: K1's.
enum SmallMode { SMALL_ENTRY = 0, SMALL_FLAT_BAND = 1, SMALL_FLAT_FULL = 2, SMALL_ENTRY_GATHER = 3 };
// phase kinds of the plan: product tiles, per-entry self-attention query
// tiles, masked attention blocks of 64 query rows, person rows x heads,
// LayerNorm rows (half a block each), token or epilogue rows (a block
// each); each item a block's unless noted
enum PhaseKind { PK_GEMM = 0, PK_SELF_ATTN = 1, PK_MASKED = 2, PK_PERSON = 3, PK_LN = 4, PK_ROWS = 5 };

// One product's split: M x N x K in bm x 64 tiles, K cut into `split`
// slices of K / split. Item i is slice i % split of tile i / split, tile t
// at row block t / (N / 64), column block t % (N / 64).
struct GemmPlan {
  int M, N, K, bm, split;
};

__host__ __device__ inline int gp_tiles(const GemmPlan& p) { return (p.M + p.bm - 1) / p.bm * (p.N / SB_BN); }
__host__ __device__ inline int gp_items(const GemmPlan& p) { return gp_tiles(p) * p.split; }

inline GemmPlan plan_gemm(int M, int N, int K, int grid, bool split_ok) {
  const int tn = N / SB_BN;
  const int bm = M > 32 ? 64 : 32;
  const int tiles = (M + bm - 1) / bm * tn;
  int s = 1;
  if (split_ok)
    while (2 * s * tiles <= grid && (K / SB_BK) % (2 * s) == 0) s *= 2;
  return GemmPlan{M, N, K, bm, s};
}

// The products of one layer (cq, co: the person rows' q and out
// projections in the band modes, every row's in the full cross; K4's co
// over every row) and K3's or K4's motion decoder (md; M = 0 elsewhere).
struct SmallPlan {
  int grid, mode;
  GemmPlan qkv, self_out, cq, co, ffn1, ffn2, md;
};

inline SmallPlan make_small_plan(int mode, int Be, int lq, int F, int FF, int grid, int n_tail, int Fd) {
  const int R = Be * lq, Mc = mode == SMALL_FLAT_FULL ? R : Be;
  SmallPlan p;
  p.grid = grid;
  p.mode = mode;
  p.qkv = plan_gemm(R, 3 * F, F, grid, false);
  p.self_out = plan_gemm(R, F, F, grid, true);
  p.cq = plan_gemm(Mc, F, F, grid, true);
  p.co = plan_gemm(mode == SMALL_ENTRY_GATHER ? R : Mc, F, F, grid, true);
  p.ffn1 = plan_gemm(R, FF, F, grid, false);
  p.ffn2 = plan_gemm(R, F, FF, grid, true);
  p.md = n_tail > 0 ? plan_gemm(n_tail, Fd, F, grid, true) : GemmPlan{0, 0, 0, 32, 1};
  return p;
}

inline bool small_shapes_ok(int lq, int F, int H, int FF) {
  return decoder_shapes_ok(lq, F, H, FF) && F % SB_BN == 0 && FF % SB_BN == 0 && F % SB_BK == 0 && FF % SB_BK == 0;
}

// The plan as a list of phases of one step: per phase {kind, items, M, N,
// K, bm, split} (M, N, K, bm, split 0 where no product runs). K3 and K4
// (n_tail > 0) add their prologue before the layers and the motion
// decoder and epilogue after them; the flat mode its copy of x in. Returns
// the count of phases; `out` takes 7 longs each.
inline int small_phases(const SmallPlan& p, int Be, int lq, int H, int L, int tile, int n_tail, int N, long* out) {
  int n = 0;
  auto add = [&](int kind, long items, const GemmPlan* g) {
    long* o = out + 7 * n++;
    o[0] = kind;
    o[1] = items;
    o[2] = g ? g->M : 0;
    o[3] = g ? g->N : 0;
    o[4] = g ? g->K : 0;
    o[5] = g ? g->bm : 0;
    o[6] = g ? g->split : 0;
  };
  const int R = Be * lq, nt = (lq + 15) / 16, n_tiles = tile > 0 ? Be / tile : 1, Rt = tile * lq;
  add(PK_ROWS, n_tail > 0 ? lq : R, nullptr);  // K3's or K4's prologue, or the flat mode's copy of x in
  for (int l = 0; l < L; ++l) {
    add(PK_GEMM, gp_items(p.qkv), &p.qkv);
    if (p.mode == SMALL_ENTRY || p.mode == SMALL_ENTRY_GATHER)
      add(PK_SELF_ATTN, (long)Be * H * nt, nullptr);
    else
      add(PK_MASKED, (long)n_tiles * H * ((Rt + MA_BQ - 1) / MA_BQ), nullptr);
    add(PK_GEMM, gp_items(p.self_out), &p.self_out);
    add(PK_LN, R, nullptr);
    add(PK_GEMM, gp_items(p.cq), &p.cq);
    if (p.mode == SMALL_FLAT_FULL)
      add(PK_MASKED, (long)n_tiles * H * ((Rt + MA_BQ - 1) / MA_BQ), nullptr);
    else
      add(PK_PERSON, (long)Be * H, nullptr);
    add(PK_GEMM, gp_items(p.co), &p.co);
    add(PK_LN, R, nullptr);
    add(PK_GEMM, gp_items(p.ffn1), &p.ffn1);
    add(PK_GEMM, gp_items(p.ffn2), &p.ffn2);
    add(PK_LN, R, nullptr);
  }
  if (n_tail > 0) {
    add(PK_GEMM, gp_items(p.md), &p.md);
    add(PK_ROWS, N, nullptr);
  }
  return n;
}

// The scratch of one call: the bf16 copy of x and the products' outputs,
// and the split-K partials (part: the R-row products; ppart: the person
// rows' q and out projections; hpart: K3's motion decoder).
struct SmallWs {
  float* x;  // (R, F) f32, where the caller does not give it
  bf16 *xb, *qkv, *sa, *h, *pa;
  float *part, *ppart, *hpart;
  int *live_self, *live_cross;  // the flat modes' masked attentions: live 64 x 64 mask blocks
};

__host__ __device__ inline int blocks64(int n) { return (n + 63) / 64; }

inline SmallWs carve_small(void* ws, const SmallPlan& p, int Be, int lq, int F, int FF, int tile, bool with_x,
                           size_t* total) {
  const size_t R = (size_t)Be * lq;
  size_t s_rows = (size_t)p.self_out.split > (size_t)p.ffn2.split ? p.self_out.split : p.ffn2.split;
  size_t s_pers = 1, live_self = 0, live_cross = 0;
  if (p.mode == SMALL_FLAT_FULL) {
    if ((size_t)p.cq.split > s_rows) s_rows = p.cq.split;
    if ((size_t)p.co.split > s_rows) s_rows = p.co.split;
  } else if (p.mode == SMALL_ENTRY_GATHER) {
    if ((size_t)p.co.split > s_rows) s_rows = p.co.split;
    s_pers = p.cq.split;
  } else {
    s_pers = p.cq.split > p.co.split ? p.cq.split : p.co.split;
  }
  if (p.mode == SMALL_FLAT_BAND || p.mode == SMALL_FLAT_FULL) {
    const int Rt = tile * lq, Mt = tile * (lq - 1);
    live_self = (size_t)blocks64(Rt) * blocks64(Rt) * 4;
    if (p.mode == SMALL_FLAT_FULL) live_cross = (size_t)blocks64(Rt) * blocks64(Mt) * 4;
  }
  const size_t sizes[11] = {with_x ? R * F * 4 : 0,
                            R * F * 2,
                            R * 3 * F * 2,
                            R * F * 2,
                            R * FF * 2,
                            (size_t)Be * F * 2,
                            s_rows * R * F * 4,
                            s_pers * Be * F * 4,
                            (size_t)p.md.split * p.md.M * p.md.N * 4,
                            live_self,
                            live_cross};
  char* base = static_cast<char*>(ws);
  void* ptrs[11];
  size_t off = 0;
  for (int i = 0; i < 11; ++i) {
    ptrs[i] = base && sizes[i] ? base + off : nullptr;
    off += align256(sizes[i]);
  }
  *total = off;
  return SmallWs{(float*)ptrs[0], (bf16*)ptrs[1], (bf16*)ptrs[2], (bf16*)ptrs[3], (bf16*)ptrs[4], (bf16*)ptrs[5],
                 (float*)ptrs[6], (float*)ptrs[7], (float*)ptrs[8], (int*)ptrs[9],  (int*)ptrs[10]};
}

// The grid of a small-stack kernel on the current device: blocks resident
// at once at SMALL_SMEM, or a negative CUDA error (no cooperative launch,
// or no block fits).
template <typename Kernel>
int small_grid(Kernel kernel, bool* attr_set) {
  if (!*attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMALL_SMEM));
    if (err != cudaSuccess) return -static_cast<int>(err);
    *attr_set = true;
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SMALL_THREADS, SMALL_SMEM);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (!coop || per_sm < 1) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return per_sm * sms;
}

// The grid a call launches: `want` blocks (0: all that fit), refused
// (cudaErrorCooperativeLaunchTooLarge) beyond what fits.
inline cudaError_t small_launch_grid(int fit, int want, int* grid) {
  if (fit < 0) return static_cast<cudaError_t>(-fit);
  if (want < 0 || want > fit) return cudaErrorCooperativeLaunchTooLarge;
  *grid = want > 0 ? want : fit;
  return cudaSuccess;
}

// --------------------------------------------------------------------------
// device side
// --------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The grid barrier between phases; with `stamps`, block 0 records the
// card's clock (ns) at the start and after every barrier.
struct PhaseClock {
  unsigned long long* stamps;
  int n;
  __device__ void start() {
    n = 0;
    mark();
  }
  __device__ void mark() {
    if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) stamps[n] = global_ns();
    ++n;
  }
  __device__ void sync() {
    cg::this_grid().sync();
    mark();
  }
};

// f32 split-K partials (S, M, N), element o of the (M, N) product: the S
// slots summed in slot order, their loads issued 8 at a time so that they
// are in flight together
__device__ __forceinline__ float part_sum(const float* part, int S, long MN, long o) {
  float v = 0.0f;
  for (int s0 = 0; s0 < S; s0 += 8) {
    float u[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) u[s] = s0 + s < S ? part[(s0 + s) * MN + o] : 0.0f;
#pragma unroll
    for (int s = 0; s < 8; ++s)
      if (s0 + s < S) v = s0 + s == 0 ? u[s] : v + u[s];
  }
  return v;
}

// The sum of `v` over the block, in a fixed order (each warp's shuffle
// tree, then the warps in order); `red` holds 8 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < SMALL_THREADS / 32; ++w) t += red[w];
  return t;
}

// SE_BF16: bf16((acc + bias) * scale on columns < scale_cols); SE_GELU:
// bf16(gelu_tanh(acc + bias)); SE_PART: the f32 partial of slice s
enum { SE_BF16 = 0, SE_GELU = 1, SE_PART = 2 };

struct SmallGemm {
  const bf16* A;
  long lda;
  const int* a_rows;    // optional: A row r is A[a_rows[r]]
  const bf16* B;        // K x N row-major (the JAX (in, out) layout)
  const bf16* bias;     // N, or null
  const float* bias_f;  // N f32, or null (added after `bias`)
  void* C;              // bf16 (M, N), or the f32 partials (split, M, N)
  float scale;
  int scale_cols;
};

// One bm x 64 tile (tm, tn), K slice s, by the block's 8 warps as a WM x WN
// grid of 16 x (64 / WN) warp tiles, from a SB_STAGES-deep cp.async ring
// of 64-deep A and B tiles.
// One bm x 64 tile (tm, tn), K slice s, by the block's 8 warps as a WM x WN
// grid of 16 x (64 / WN) warp tiles, from a SB_STAGES-deep cp.async ring
// of 64-deep A and B tiles.
template <int BM, int EPI>
__device__ __forceinline__ void small_tile(const SmallGemm& g, const GemmPlan& p, int tm, int tn, int s,
                                           unsigned char* smem) {
  constexpr int WM = BM / 16, WN = 8 / WM, FN = 4 / WN;
  bf16* As = reinterpret_cast<bf16*>(smem);   // [STAGES][BM][SB_LD]
  bf16* Bs = As + SB_STAGES * BM * SB_LD;     // [STAGES][SB_BK][SB_LD]
  float* Cs = reinterpret_cast<float*>(Bs + SB_STAGES * SB_BK * SB_LD);  // [8 warps][16][C_LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = tm * BM, n0 = tn * SB_BN;
  const int kc = p.K / p.split, kbeg = s * kc, KT = kc / SB_BK;
  const bf16 *A = g.A, *B = g.B;
  const int* a_rows = g.a_rows;
  const long lda = g.lda, N = p.N;
  const int M = p.M;
  __syncthreads();  // the block's previous item is done with shared memory

  auto load = [&](int stage, int k0) {
    bf16* as = As + stage * BM * SB_LD;
    bf16* bs = Bs + stage * SB_BK * SB_LD;
    for (int i = tid; i < BM * (SB_BK / 8); i += SMALL_THREADS) {
      const int r = i / (SB_BK / 8), c = (i % (SB_BK / 8)) * 8, gr = m0 + r;
      const bool ok = gr < M;
      const bf16* src = A;
      if (ok) src = A + (long)(a_rows ? a_rows[gr] : gr) * lda + k0 + c;
      cp_async16(as + r * SB_LD + c, src, ok);
    }
    for (int i = tid; i < SB_BK * (SB_BN / 8); i += SMALL_THREADS) {
      const int r = i / (SB_BN / 8), c = (i % (SB_BN / 8)) * 8;
      cp_async16(bs + r * SB_LD + c, B + (long)(k0 + r) * N + n0 + c, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FN];
#pragma unroll
  for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int st = 0; st < SB_STAGES - 1; ++st) {
    if (st < KT) load(st, kbeg + st * SB_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<SB_STAGES - 2>();
    __syncthreads();
    if (kt + SB_STAGES - 1 < KT) load((kt + SB_STAGES - 1) % SB_STAGES, kbeg + (kt + SB_STAGES - 1) * SB_BK);
    cp_async_commit();
    const bf16* as = As + (kt % SB_STAGES) * BM * SB_LD;
    const bf16* bs = Bs + (kt % SB_STAGES) * SB_BK * SB_LD;
#pragma unroll
    for (int kk = 0; kk < SB_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, as + (wm * 16) * SB_LD + kk, SB_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, bs + kk * SB_LD + (wn * FN + j) * 16, SB_LD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  cp_async_wait<0>();

  // each fragment through the warp's 16 x 16 staging tile; lane (r, half)
  // then owns 8 consecutive columns of row r
  float* cs = Cs + warp * 16 * C_LD;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int j = 0; j < FN; ++j) {
    wmma::store_matrix_sync(cs, acc[j], C_LD, wmma::mem_row_major);
    __syncwarp();
    const int gr = m0 + wm * 16 + r, gc = n0 + (wn * FN + j) * 16 + c0;
    if (gr < p.M) {
      float v[8];
      const float4 lo = *reinterpret_cast<const float4*>(cs + r * C_LD + c0);
      const float4 hi = *reinterpret_cast<const float4*>(cs + r * C_LD + c0 + 4);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      if (EPI == SE_PART) {
        float4* out = reinterpret_cast<float4*>(static_cast<float*>(g.C) + ((long)s * p.M + gr) * p.N + gc);
        out[0] = make_float4(v[0], v[1], v[2], v[3]);
        out[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        if (g.bias) {
          const uint4 ub = *reinterpret_cast<const uint4*>(g.bias + gc);
          const bf16* b8 = reinterpret_cast<const bf16*>(&ub);
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] += __bfloat162float(b8[t]);
        }
        if (g.bias_f) {
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] += g.bias_f[gc + t];
        }
        uint4 packed;
        bf16* p8 = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float y = v[t];
          if (EPI == SE_BF16 && gc + t < g.scale_cols) y *= g.scale;
          if (EPI == SE_GELU) y = gelu_tanh(y);
          p8[t] = __float2bfloat16(y);
        }
        *reinterpret_cast<uint4*>(static_cast<bf16*>(g.C) + (long)gr * p.N + gc) = packed;
      }
    }
    __syncwarp();
  }
}

// d (64 x 64 f32 of this warpgroup) += A (64 x 16, K-major) B (16 x 64,
// N-major: the JAX (in, out) layout, wgmma's transposed-B mode)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// mbar_wait that gives up (a trap, so the launch fails with an error
// instead of hanging the card) after a second of spinning
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, unsigned parity) {
  const unsigned long long t0 = global_ns();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (global_ns() - t0 > 1000000000ull) __trap();
  }
}

// One 64 x 64 tile (tm, tn), K slice s, of a product whose A (rows not
// gathered) and B reach the kernel as tensor maps (ta: box 64 k x 64 rows;
// tb: box 64 columns x 64 k of layer `layer`), in the 128-byte swizzle
// that wgmma's descriptors read. Thread 0 issues the TMA copies of up to
// WG_STAGES k-tiles at once, each completing on its stage's mbarrier; the
// two warpgroups take the even and the odd k-tiles (wgmma m64n64k16, f32
// accumulators in registers), and warpgroup 0 adds warpgroup 1's sums
// (fixed order) and runs the epilogue. TMA zero-fills rows past M, which
// are not stored.
template <int EPI>
__device__ __forceinline__ void small_wg_tile(const SmallGemm& g, const GemmPlan& p, const CUtensorMap* ta,
                                              const CUtensorMap* tb, int layer, int tm, int tn, int s,
                                              unsigned char* smem_raw) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* sm = smem_raw + pad;  // the ring, aligned to the 1024-byte swizzle atom
  const uint32_t s0 = raw + pad;
  float* red = reinterpret_cast<float*>(sm + WG_STAGES * WG_STAGE);  // [128 threads][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 128 * 32);
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = tm * 64, n0 = tn * SB_BN;
  const int kc = p.K / p.split, kbeg = s * kc, KT = kc / SB_BK;
  __syncthreads();  // the block's previous item is done with shared memory
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < WG_STAGES; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  for (int r0 = 0, round = 0; r0 < KT; r0 += WG_STAGES, ++round) {
    const int n = KT - r0 < WG_STAGES ? KT - r0 : WG_STAGES;
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int j = 0; j < n; ++j) {
        unsigned char* st = sm + j * WG_STAGE;
        const int k0 = kbeg + (r0 + j) * SB_BK;
        mbar_expect_tx(&full[j], WG_STAGE);
        tma_load(st, ta, &full[j], k0, m0, 0);
        tma_load(st + 64 * 128, tb, &full[j], n0, k0, layer);
      }
    }
    wgmma_fence();
    for (int j = wg; j < n; j += 2) {
      mbar_wait_bounded(&full[j], round & 1);
      const uint32_t a = s0 + j * WG_STAGE, b = a + 64 * 128;
#pragma unroll
      for (int kk = 0; kk < SB_BK / 16; ++kk)
        wgmma_m64n64k16(d, sm90_desc(a + kk * 32, 16, 1024), sm90_desc(b + kk * 2048, SB_BK * 128, 1024));
      wgmma_commit();
    }
    wgmma_wait<0>();
    __syncthreads();  // every stage of this round is read: the next round may refill them
  }
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) red[i * 128 + (tid - 128)] = d[i];
  }
  __syncthreads();
  if (tid == 0)
#pragma unroll
    for (int st = 0; st < WG_STAGES; ++st) mbar_inval(&full[st]);
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] += red[i * 128 + tid];

  // d[4j + {0, 1}]: row r0, columns c + {0, 1}; d[4j + {2, 3}]: row r0 + 8
  const int lane = tid % 32, warp = tid / 32;
  const int r0 = m0 + warp * 16 + lane / 4, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane % 4);
    if (EPI == SE_PART) {
      float* out = static_cast<float*>(g.C) + (long)s * p.M * p.N;
      if (r0 < p.M) *reinterpret_cast<float2*>(out + (long)r0 * p.N + c) = make_float2(d[4 * j], d[4 * j + 1]);
      if (r1 < p.M) *reinterpret_cast<float2*>(out + (long)r1 * p.N + c) = make_float2(d[4 * j + 2], d[4 * j + 3]);
    } else {
      float2 bj = make_float2(0.0f, 0.0f);
      if (g.bias) bj = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + c));
      if (g.bias_f) {
        bj.x += g.bias_f[c];
        bj.y += g.bias_f[c + 1];
      }
      float v[4] = {d[4 * j] + bj.x, d[4 * j + 1] + bj.y, d[4 * j + 2] + bj.x, d[4 * j + 3] + bj.y};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (EPI == SE_BF16 && c + (t & 1) < g.scale_cols) v[t] *= g.scale;
        if (EPI == SE_GELU) v[t] = gelu_tanh(v[t]);
      }
      bf16* C = static_cast<bf16*>(g.C);
      if (r0 < p.M) *reinterpret_cast<__nv_bfloat162*>(C + (long)r0 * p.N + c) = __floats2bfloat162_rn(v[0], v[1]);
      if (r1 < p.M) *reinterpret_cast<__nv_bfloat162*>(C + (long)r1 * p.N + c) = __floats2bfloat162_rn(v[2], v[3]);
    }
  }
}

// Every item of one product, strided over the persistent blocks.
// With tensor maps ta and tb (A not gathered, 64-row tiles): the wgmma
// tile; without (the person rows' and K3's motion decoder's products,
// whose A rows are gathered; split-K partials only): the wmma tile. The
// tiles are inlined: as calls (one body each, less code) they ran slower
// on the card.
template <int EPI>
__device__ __forceinline__ void small_gemm_phase(const SmallGemm& g, const GemmPlan& p, unsigned char* smem,
                                                 const CUtensorMap* ta = nullptr, const CUtensorMap* tb = nullptr,
                                                 int layer = 0) {
  const int tn = p.N / SB_BN, n = gp_items(p);
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int s = i % p.split, t = i / p.split;
    if (ta != nullptr)
      small_wg_tile<EPI>(g, p, ta, tb, layer, t / tn, t % tn, s, smem);
    else if constexpr (EPI == SE_PART) {  // only the gathered rows' products take the wmma tile
      if (p.bm == 64)
        small_tile<64, EPI>(g, p, t / tn, t % tn, s, smem);
      else
        small_tile<32, EPI>(g, p, t / tn, t % tn, s, smem);
    } else {
      __trap();
    }
  }
}

// Query tile qt (rows 16 qt ..) of entry e, head h of the per-entry
// self-attention: self_attn_block's computation for those 16 rows (the
// same fragments, sums and bf16 numerators in the same order), by warp 0
// after all 8 warps load Q's 16 rows and all of K and V. (Splitting the
// keys over 4 warps, with their partials added through shared memory, ran
// slower on the card.)
__device__ __noinline__ void self_attn_qtile(const bf16* __restrict__ qkv, bf16* __restrict__ out, int lq, int F,
                                             int h, int e, int qt, unsigned char* smem) {
  constexpr int NT = MAX_LM / 16;
  __syncthreads();  // the block's previous item is done with smem
  const int nt = (lq + 15) / 16, lp = nt * 16, q0 = qt * 16;
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + 16 * 128;
  unsigned char* Vs = Ks + lp * 128;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long row0 = (long)e * lq, ld = 3L * F;

  for (int i = tid; i < lp * 8; i += SMALL_THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < lq;
    cp_async16(Ks + swz(r, c), qkv + (row0 + (ok ? r : 0)) * ld + F + h * DH + c * 8, ok);
    if (r < 16) {
      const bool qok = q0 + r < lq;
      cp_async16(Qs + swz(r, c), qkv + (row0 + (qok ? q0 + r : 0)) * ld + h * DH + c * 8, qok);
    }
  }
  cp_async_commit();
  for (int i = tid; i < lp * 8; i += SMALL_THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < lq;
    cp_async16(Vs + swz(r, c), qkv + (row0 + (ok ? r : 0)) * ld + 2 * F + h * DH + c * 8, ok);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const bool active = warp == 0;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, c2 = 2 * (lane & 3);
  uint32_t p[NT][4];
  float l_lo = 0.0f, l_hi = 0.0f;
  if (active) {
    float s[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(smem_u32(Qs + swz(lr, kk * 2 + (lane >> 4))), a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_u32(Ks + swz(j * 16 + (lane & 7) + (lane >> 4) * 8, kk * 2 + ((lane >> 3) & 1))), b0, b1,
                  b2, b3);
          mma_bf16(s[2 * j], a, b0, b1);
          mma_bf16(s[2 * j + 1], a, b2, b3);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const bool key = 8 * j + c2 + t < lq;
        s[j][t] = key ? fast_exp(s[j][t]) : 0.0f;
        s[j][2 + t] = key ? fast_exp(s[j][2 + t]) : 0.0f;
        l_lo += s[j][t];
        l_hi += s[j][2 + t];
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      p[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      p[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      p[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      p[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
    }
  }
  cp_async_wait<0>();  // V
  __syncthreads();
  if (!active) return;

  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_u32(Vs + swz(j * 16 + lr, nd * 2 + (lane >> 4))), b0, b1, b2, b3);
        mma_bf16(o[2 * nd], p[j], b0, b1);
        mma_bf16(o[2 * nd + 1], p[j], b2, b3);
      }
    }
  }
  const float i_lo = 1.0f / l_lo, i_hi = 1.0f / l_hi;
  const int g = lane >> 2;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    *reinterpret_cast<uint32_t*>(Qs + swz(g, n) + 2 * c2) = pack_bf16(o[n][0] * i_lo, o[n][1] * i_lo);
    *reinterpret_cast<uint32_t*>(Qs + swz(g + 8, n) + 2 * c2) = pack_bf16(o[n][2] * i_hi, o[n][3] * i_hi);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3, c = i & 7;
    if (q0 + r < lq)
      *reinterpret_cast<uint4*>(out + (row0 + q0 + r) * F + h * DH + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz(r, c));
  }
}

// Person row e (of the Be person rows) against keys krow0 .. krow0 + nk of
// km / vm, head h, by the whole block: q = bf16((the summed split-K
// partials of the q projection (S, Be, F) + bcq) * scale); the scores s = q
// k^T in f32, plus the mask row `mask` (nk floats; null: none); the bf16
// fast numerators exp(clamp(s - 20, -80, 60)) (0 where s + mask - 20 is at
// or below MASK_FLOOR) and their f32 sum; out = bf16((numerators V) /
// sum) into row `out_row` of out. The keys come through shared memory
// PA_KEYS at a time (cp.async), and a chunk whose mask is all at or below
// MASK_FLOOR is skipped: it adds exactly 0. The identity band's
// person_attn_block, with the person mask of the flat mode.
__device__ __noinline__ void person_block(const float* __restrict__ qpart, int S, long MN,
                                          const bf16* __restrict__ bcq, float scale, const bf16* __restrict__ km,
                                          const bf16* __restrict__ vm, long krow0, int nk, const float* mask,
                                          bf16* __restrict__ out, long out_row, int F, int e, int h,
                                          unsigned char* smem) {
  bf16* Ks = reinterpret_cast<bf16*>(smem);           // [PA_KEYS][DH]
  bf16* Vs = Ks + PA_KEYS * DH;                       // [PA_KEYS][DH]
  float* qs = reinterpret_cast<float*>(Vs + PA_KEYS * DH);  // DH
  float* ps = qs + DH;                                // PA_KEYS bf16-rounded numerators
  float* os = ps + PA_KEYS;                           // 4 x DH partial outputs
  float* red = os + 4 * DH;                           // 8
  const int tid = threadIdx.x;
  __syncthreads();  // the block's previous item is done with smem
  if (tid < DH) {
    const int c = h * DH + tid;
    qs[tid] = round_bf16((part_sum(qpart, S, MN, (long)e * F + c) + __bfloat162float(bcq[c])) * scale);
  }
  float sum = 0.0f, acc = 0.0f;  // this thread's numerator sum and (d, quarter) output sum
  const int d = tid % DH, quarter = tid / DH;
  for (int j0 = 0; j0 < nk; j0 += PA_KEYS) {
    const int n = nk - j0 < PA_KEYS ? nk - j0 : PA_KEYS;
    if (mask) {
      int live = 0;
      for (int j = tid; j < n; j += SMALL_THREADS) live |= mask[j0 + j] > MASK_FLOOR;
      if (!__syncthreads_or(live)) continue;
    }
    __syncthreads();  // the previous chunk is done with Ks, Vs, ps
    for (int i = tid; i < n * (DH / 8); i += SMALL_THREADS) {
      const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
      cp_async16(Ks + r * DH + c, km + (krow0 + j0 + r) * F + h * DH + c, true);
      cp_async16(Vs + r * DH + c, vm + (krow0 + j0 + r) * F + h * DH + c, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (tid < n) {
      float sc = 0.0f;
#pragma unroll
      for (int k = 0; k < DH; k += 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(Ks + tid * DH + k);
        const bf16* k8 = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int t = 0; t < 8; ++t) sc += qs[k + t] * __bfloat162float(k8[t]);
      }
      const float sh = (sc + (mask ? mask[j0 + tid] : 0.0f)) - 20.0f;
      const float p = sh > MASK_FLOOR ? expf(fminf(fmaxf(sh, -80.0f), 60.0f)) : 0.0f;
      ps[tid] = round_bf16(p);
      sum += p;
    }
    __syncthreads();
    for (int j = quarter; j < n; j += 4) acc += ps[j] * __bfloat162float(Vs[j * DH + d]);
  }
  const float total = block_sum(sum, red);
  os[quarter * DH + d] = acc;
  __syncthreads();
  if (tid < DH) {
    const float o = ((os[tid] + os[DH + tid]) + os[2 * DH + tid]) + os[3 * DH + tid];
    out[out_row * F + h * DH + tid] = __float2bfloat16(o * (1.0f / total));
  }
}

struct MaskedAttnArgs {
  const bf16 *q, *k, *v;  // row r of head h at base + r * ld + h * DH
  long ldq, ldk, ldv;
  const float* mask;  // (rq, rk) additive f32, the same for every tile
  bf16* out;          // row r of head h at out + r * ldo + h * DH
  long ldo;
  int rq, rk;  // query rows and key rows per tile
  // q from split-K partials (S, rows, ldq) instead: bf16((sum + bias) * scale)
  const float* q_part;
  int q_split;
  long q_mn;
  const bf16* q_bias;
  float q_scale;
  const int* live;  // (ceil(rq / 64), ceil(rk / 64)): whether a 64 x 64 block of the mask has a live entry
};

// Whether the 64 x 64 block (qb, kb) of an (rq, rk) mask has an entry above
// MASK_FLOOR, into live[qb * ceil(rk / 64) + kb]; by the whole block.
__device__ __noinline__ void mask_live_block(const float* mask, int rq, int rk, int qb, int kb, int* live) {
  int any = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < MA_BQ * MA_BK; i += SMALL_THREADS) {
    const int r = qb * MA_BQ + i / MA_BK, c = kb * MA_BK + i % MA_BK;
    if (r < rq && c < rk) any |= mask[(long)r * rk + c] > MASK_FLOOR;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) live[qb * ((rk + MA_BK - 1) / MA_BK) + kb] = any;
}

// One 64-query-row block qb of head h in tile t: out = (exp(clamp_unmasked(q
// k^T + mask - 20)) v) / rowsum, with q already scaled and every product on
// bf16 operands with f32 accumulation (mma.sync m16n8k16). The fixed shift
// needs no running max, so the numerators and row sums of the live 64-key
// blocks (a.live; a fully masked block adds exactly 0 and is skipped)
// simply add up: warps 0-3 (16 query rows each) take the even live blocks
// and warps 4-7 the odd ones, each group streaming its K and V through two
// swizzled buffers (cp.async, the next block in flight while one is
// computed), scores and bf16 numerators in registers as in
// self_attn_block; then group 0 adds group 1's sums (fixed order) and
// writes out. Tile t's query rows are t * rq .. and its key rows t * rk ..
__device__ __noinline__ void masked_attn_item(const MaskedAttnArgs& a, int qb, int h, int t, unsigned char* smem) {
  unsigned char* Qs = smem;                    // [64][64] bf16, swizzled
  unsigned char* KV = Qs + MA_BQ * 128;        // [group][buffer][K | V][64][64] bf16, swizzled
  float* Os = reinterpret_cast<float*>(KV + 2 * 2 * 2 * MA_BK * 128);  // group 1's [64 rows][64] sums
  float* Ls = Os + MA_BQ * DH;                 // group 1's [64] row sums
  int* lv = reinterpret_cast<int*>(Ls + MA_BQ);  // the live key blocks, then their count
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, grp = warp / 4, wq = warp % 4;
  const int gt = tid % 128;  // thread of its group
  const int q0 = qb * MA_BQ, nkb = (a.rk + MA_BK - 1) / MA_BK;
  const long qrow0 = (long)t * a.rq + q0, krow0 = (long)t * a.rk;
  __syncthreads();  // the block's previous item is done with smem
  if (tid == 0) {
    int n = 0;
    for (int kb = 0; kb < nkb; ++kb)
      if (a.live[qb * nkb + kb]) lv[n++] = kb;
    lv[MAX_LM] = n;
  }
  for (int i = tid; i < MA_BQ * (DH / 8); i += SMALL_THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = q0 + r < a.rq;
    if (a.q_part) {
      uint4 q = make_uint4(0, 0, 0, 0);
      if (ok) {
        bf16* q8 = reinterpret_cast<bf16*>(&q);
        const long o = (qrow0 + r) * a.ldq + h * DH + c * 8;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float v = part_sum(a.q_part, a.q_split, a.q_mn, o + u) + __bfloat162float(a.q_bias[h * DH + c * 8 + u]);
          q8[u] = __float2bfloat16(v * a.q_scale);
        }
      }
      *reinterpret_cast<uint4*>(Qs + swz(r, c)) = q;
    } else {
      cp_async16(Qs + swz(r, c), a.q + (qrow0 + (ok ? r : 0)) * a.ldq + h * DH + c * 8, ok);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // Q and lv
  const int nlive = lv[MAX_LM];

  // this group's j-th live block (live index grp + 2 j) into buffer j % 2
  auto load = [&](int j) {
    const int li = grp + 2 * j;
    if (li >= nlive) return;
    const int kb = lv[li] * MA_BK;
    unsigned char* Ks = KV + ((grp * 2 + (j & 1)) * 2) * MA_BK * 128;
    unsigned char* Vs = Ks + MA_BK * 128;
    for (int i = gt; i < MA_BK * 8; i += 128) {
      const int r = i >> 3, c = i & 7;
      const bool ok = kb + r < a.rk;
      const long row = krow0 + kb + (ok ? r : 0);
      cp_async16(Ks + swz(r, c), a.k + row * a.ldk + h * DH + c * 8, ok);
      cp_async16(Vs + swz(r, c), a.v + row * a.ldv + h * DH + c * 8, ok);
    }
  };
  load(0);
  cp_async_commit();

  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, c2 = 2 * (lane & 3), g8 = lane >> 2;
  const int rq_lo = q0 + wq * 16 + g8, rq_hi = rq_lo + 8;  // this thread's query rows in the tile
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float l_lo = 0.0f, l_hi = 0.0f;
  for (int j = 0; grp + 2 * j < nlive; ++j) {
    load(j + 1);  // the next block of this group, if any, into the other buffer
    cp_async_commit();
    cp_async_wait<1>();  // block j has landed
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + grp));
    const int kb = lv[grp + 2 * j] * MA_BK;
    const unsigned char* Ks = KV + ((grp * 2 + (j & 1)) * 2) * MA_BK * 128;
    const unsigned char* Vs = Ks + MA_BK * 128;
    float sc[2 * MA_BK / 16][4];
#pragma unroll
    for (int n = 0; n < 2 * MA_BK / 16; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(smem_u32(Qs + swz(wq * 16 + lr, kk * 2 + (lane >> 4))), qa[0], qa[1], qa[2], qa[3]);
#pragma unroll
      for (int jj = 0; jj < MA_BK / 16; ++jj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(Ks + swz(jj * 16 + (lane & 7) + (lane >> 4) * 8, kk * 2 + ((lane >> 3) & 1))), b0, b1, b2,
                b3);
        mma_bf16(sc[2 * jj], qa, b0, b1);
        mma_bf16(sc[2 * jj + 1], qa, b2, b3);
      }
    }
    // numerators: the mask is added before the floor test, the -20 shift
    // after it (-1e30 - 20 == -1e30 in f32); a masked score's exp is 0
    uint32_t pf[MA_BK / 16][4];
#pragma unroll
    for (int n = 0; n < 2 * MA_BK / 16; ++n) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int key = kb + 8 * n + c2 + u;
        const bool kok = key < a.rk;
        const float m_lo = kok && rq_lo < a.rq ? a.mask[(long)rq_lo * a.rk + key] : -1e30f;
        const float m_hi = kok && rq_hi < a.rq ? a.mask[(long)rq_hi * a.rk + key] : -1e30f;
        const float sh_lo = (sc[n][u] + m_lo) - 20.0f, sh_hi = (sc[n][2 + u] + m_hi) - 20.0f;
        sc[n][u] = sh_lo > MASK_FLOOR ? expf(fminf(fmaxf(sh_lo, -80.0f), 60.0f)) : 0.0f;
        sc[n][2 + u] = sh_hi > MASK_FLOOR ? expf(fminf(fmaxf(sh_hi, -80.0f), 60.0f)) : 0.0f;
        l_lo += sc[n][u];
        l_hi += sc[n][2 + u];
      }
    }
#pragma unroll
    for (int jj = 0; jj < MA_BK / 16; ++jj) {
      pf[jj][0] = pack_bf16(sc[2 * jj][0], sc[2 * jj][1]);
      pf[jj][1] = pack_bf16(sc[2 * jj][2], sc[2 * jj][3]);
      pf[jj][2] = pack_bf16(sc[2 * jj + 1][0], sc[2 * jj + 1][1]);
      pf[jj][3] = pack_bf16(sc[2 * jj + 1][2], sc[2 * jj + 1][3]);
    }
#pragma unroll
    for (int jj = 0; jj < MA_BK / 16; ++jj) {
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_u32(Vs + swz(jj * 16 + lr, nd * 2 + (lane >> 4))), b0, b1, b2, b3);
        mma_bf16(o[2 * nd], pf[jj], b0, b1);
        mma_bf16(o[2 * nd + 1], pf[jj], b2, b3);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + grp));  // the group is done with buffer j % 2
  }
  cp_async_wait<0>();
#pragma unroll
  for (int u = 1; u < 4; u <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, u);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, u);
  }
  const int r_lo = wq * 16 + g8, r_hi = r_lo + 8;  // rows of the item
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int c = 8 * n + c2;
      *reinterpret_cast<float2*>(Os + r_lo * DH + c) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(Os + r_hi * DH + c) = make_float2(o[n][2], o[n][3]);
    }
    if ((lane & 3) == 0) {
      Ls[r_lo] = l_lo;
      Ls[r_hi] = l_hi;
    }
  }
  __syncthreads();
  if (grp == 1) return;
  l_lo += Ls[r_lo];
  l_hi += Ls[r_hi];
  const float i_lo = 1.0f / l_lo, i_hi = 1.0f / l_hi;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = 8 * n + c2;
    const float2 plo = *reinterpret_cast<const float2*>(Os + r_lo * DH + c);
    const float2 phi = *reinterpret_cast<const float2*>(Os + r_hi * DH + c);
    const float2 lo = make_float2(o[n][0] + plo.x, o[n][1] + plo.y), hi = make_float2(o[n][2] + phi.x, o[n][3] + phi.y);
    if (q0 + r_lo < a.rq)
      *reinterpret_cast<__nv_bfloat162*>(a.out + (qrow0 + r_lo) * a.ldo + h * DH + c) =
          __floats2bfloat162_rn(lo.x * i_lo, lo.y * i_lo);
    if (q0 + r_hi < a.rq)
      *reinterpret_cast<__nv_bfloat162*>(a.out + (qrow0 + r_hi) * a.ldo + h * DH + c) =
          __floats2bfloat162_rn(hi.x * i_hi, hi.y * i_hi);
  }
}

__device__ __forceinline__ void masked_phase(const MaskedAttnArgs& a, int H, int n_tiles, unsigned char* smem) {
  const int nqb = (a.rq + MA_BQ - 1) / MA_BQ, n = n_tiles * H * nqb;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int rest = i / nqb;
    masked_attn_item(a, i % nqb, rest % H, rest / H, smem);
  }
}

// Everything one small-stack call reads and writes.
// The tensor maps of the products on the wgmma tile: the activations as A
// (64-row boxes) and each weight stack over the L layers as B. Built on the
// host once per call (the workspace is the call's).
struct SmallMaps {
  CUtensorMap xb, sa, h, wqkv, wso, wcq, wco, wf1, wf2;
};

inline cudaError_t make_small_maps(SmallMaps* m, const SmallWs& w, const DecoderWeights& p, int R, int F, int FF,
                                   int L) {
  RETURN_IF_ERROR(make_a_map(&m->xb, w.xb, F, R, F, 64));
  RETURN_IF_ERROR(make_a_map(&m->sa, w.sa, F, R, F, 64));
  RETURN_IF_ERROR(make_a_map(&m->h, w.h, FF, R, FF, 64));
  RETURN_IF_ERROR(make_b_map(&m->wqkv, p.wqkv, F, 3 * F, L));
  RETURN_IF_ERROR(make_b_map(&m->wso, p.wso, F, F, L));
  RETURN_IF_ERROR(make_b_map(&m->wcq, p.wcq, F, F, L));
  RETURN_IF_ERROR(make_b_map(&m->wco, p.wco, F, F, L));
  RETURN_IF_ERROR(make_b_map(&m->wf1, p.wf1, F, FF, L));
  return make_b_map(&m->wf2, p.wf2, FF, F, L);
}

struct SmallArgs {
  SmallMaps maps;  // first: CUtensorMap is 64-byte aligned
  SmallPlan plan;
  SmallWs w;
  float* x;            // (R, F) f32 activations, updated in place
  const float* x_in;   // the flat mode's input (copied into x and w.xb first)
  DecoderWeights p;    // vmw: bf16 (K1's band), f32 (K3), null (full cross, K4)
  const int* rows;     // (Be,) person rows (the band modes)
  const float *self_mask, *cross_mask;  // the flat modes
  int cross_f32;       // K3: the cross output and vmw stay f32 (K1's band rounds them to bf16; unread by K4)
  int Be, lq, F, H, L, FF, tile;
  unsigned long long* stamps;  // optional: the card's clock after every phase
};

// LayerNorm rows two a block: threads 0-127 take one row, 128-255 the
// next, F / 128 columns a thread.
constexpr int LN_HALF = SMALL_THREADS / 2;
constexpr int LN_COLS = 8;  // F <= 1024

// The sum of `v` over this thread's half of the block (4 warps), in a fixed
// order; `red` holds 8 floats of shared memory.
__device__ __forceinline__ float half_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  const int w0 = (threadIdx.x / LN_HALF) * (LN_HALF / 32);
  return ((red[w0] + red[w0 + 1]) + red[w0 + 2]) + red[w0 + 3];
}

// LayerNorm of one row by half the block, of x + (the summed split-K
// partials of a residual product + bias) (BAND false), or of the identity
// band's cross row x + ((person row ? po : 0) + vmw + bco) with po the
// summed partials of the person rows' out projection, rounded to bf16
// unless F32 (BAND true; `part` then (S, Be, F)); writes x and its bf16
// copy. ln_row's formula; the row's sums run over the half block. Both
// halves call it (the sums hold block barriers); a half whose row is past
// the end (`valid` false) writes nothing.
template <bool BAND, bool F32>
__device__ __noinline__ void small_ln_row(const SmallArgs& a, int row, bool valid, const float* part, int S,
                                          long MN, const bf16* bias, const void* vmw, const float* lns,
                                          const float* lnb, float* red) {
  const int F = a.F, t = threadIdx.x % LN_HALF;
  const long base = (long)row * F;
  int pe = -1;
  if (BAND && valid) {
    const int e = row / a.lq;
    if (a.rows[e] == row) pe = e;
  }
  float v[LN_COLS];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_COLS; ++i) {
    const int c = t + LN_HALF * i;
    v[i] = 0.0f;
    if (valid && c < F) {
      float x;
      if (BAND) {
        float po = 0.0f;
        if (pe >= 0) {
          po = part_sum(part, S, MN, (long)pe * F + c);
          if (!F32) po = round_bf16(po);
        }
        const float vm = F32 ? static_cast<const float*>(vmw)[base + c]
                             : __bfloat162float(static_cast<const bf16*>(vmw)[base + c]);
        float ca = po + vm;
        ca = ca + __bfloat162float(bias[c]);
        x = a.x[base + c] + ca;
      } else {
        x = a.x[base + c] + (part_sum(part, S, MN, base + c) + __bfloat162float(bias[c]));
      }
      v[i] = x;
      sum += x;
    }
  }
  const float mu = half_sum(sum, red) / F;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_COLS; ++i)
    if (valid && t + LN_HALF * i < F) sq += (v[i] - mu) * (v[i] - mu);
  const float rstd = rsqrtf(half_sum(sq, red) / F + 1e-5f);
  if (!valid) return;
#pragma unroll
  for (int i = 0; i < LN_COLS; ++i) {
    const int c = t + LN_HALF * i;
    if (c < F) {
      const float o = (v[i] - mu) * rstd * lns[c] + lnb[c];
      a.x[base + c] = o;
      a.w.xb[base + c] = __float2bfloat16(o);
    }
  }
}

template <bool BAND, bool F32>
__device__ __forceinline__ void small_ln_phase(const SmallArgs& a, const float* part, int S, long MN,
                                               const bf16* bias, const void* vmw, const float* lns,
                                               const float* lnb, unsigned char* smem) {
  const int R = a.Be * a.lq;
  for (int r0 = 2 * blockIdx.x; r0 < R; r0 += 2 * gridDim.x) {
    const int row = r0 + threadIdx.x / LN_HALF;
    small_ln_row<BAND, F32>(a, row, row < R, part, S, MN, bias, vmw, lns, lnb, reinterpret_cast<float*>(smem));
  }
}

// All L layers on a.x and its bf16 copy a.w.xb, with a barrier after every
// phase but the last when `end` (nothing follows in this launch) and no
// clock is kept.
__device__ void small_layers(const SmallArgs& a, PhaseClock& clk, unsigned char* smem, bool end) {
  const SmallPlan& P = a.plan;
  const SmallWs& w = a.w;
  const DecoderWeights& p = a.p;
  const int Be = a.Be, lq = a.lq, F = a.F, H = a.H, FF = a.FF, R = Be * lq, lm = lq - 1;
  const int tile = a.tile > 0 ? a.tile : Be, n_tiles = Be / tile, Rt = tile * lq, Mt = tile * lm;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const bool gather = P.mode == SMALL_ENTRY_GATHER, entry = P.mode == SMALL_ENTRY || gather;
  const bool full = P.mode == SMALL_FLAT_FULL;

  for (int l = 0; l < a.L; ++l) {
    const float* lns = p.ln_scale + (size_t)l * 3 * F;
    const float* lnb = p.ln_bias + (size_t)l * 3 * F;
    const bf16* Km = p.kmem + (size_t)l * Be * lm * F;
    const bf16* Vm = p.vmem + (size_t)l * Be * lm * F;
    const bf16* Bcq = p.bcq + (size_t)l * F;
    const bf16* Bco = p.bco + (size_t)l * F;

    // self-attention
    small_gemm_phase<SE_BF16>(SmallGemm{w.xb, F, nullptr, p.wqkv + (size_t)l * F * 3 * F, p.bqkv + (size_t)l * 3 * F,
                                        nullptr, w.qkv, scale, F},
                              P.qkv, smem, &a.maps.xb, &a.maps.wqkv, l);
    clk.sync();
    if (entry) {
      const int nt = (lq + 15) / 16;
      for (int i = blockIdx.x; i < Be * H * nt; i += gridDim.x) {
        const int rest = i / nt;
        self_attn_qtile(w.qkv, w.sa, lq, F, rest % H, rest / H, i % nt, smem);
      }
    } else {
      masked_phase(MaskedAttnArgs{w.qkv, w.qkv + F, w.qkv + 2 * F, 3L * F, 3L * F, 3L * F, a.self_mask, w.sa, F, Rt,
                                  Rt, nullptr, 0, 0, nullptr, 0.0f, w.live_self},
                   H, n_tiles, smem);
    }
    clk.sync();
    small_gemm_phase<SE_PART>(
        SmallGemm{w.sa, F, nullptr, p.wso + (size_t)l * F * F, nullptr, nullptr, w.part, 1.0f, 0}, P.self_out, smem,
        &a.maps.sa, &a.maps.wso, l);
    clk.sync();
    small_ln_phase<false, false>(a, w.part, P.self_out.split, (long)R * F, p.bso + (size_t)l * F, nullptr, lns, lnb,
                                 smem);
    clk.sync();

    if (gather) {
      // K4's identity band: [bf16(person output) | memory V rows] @ wco
      // over every row. The person rows attend their memory and write
      // their output into row e*lq of w.sa (free since self-out read it),
      // the same phase copies motion row e*lq + 1 + i's memory V row e*lm
      // + i beside them, then wco runs on all R rows (split-K) and the
      // cross LayerNorm sums its partials as self-out's does.
      small_gemm_phase<SE_PART>(
          SmallGemm{w.xb, F, a.rows, p.wcq + (size_t)l * F * F, nullptr, nullptr, w.ppart, 1.0f, 0}, P.cq, smem);
      clk.sync();
      for (int it = blockIdx.x; it < Be * H; it += gridDim.x) {
        const int e = it / H, h = it % H;
        person_block(w.ppart, P.cq.split, (long)Be * F, Bcq, scale, Km, Vm, (long)e * lm, lm, nullptr, w.sa,
                     (long)e * lq, F, e, h, smem);
      }
      const long chunks = (long)Be * lm * (F / 8);
      for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < chunks; i += (long)gridDim.x * blockDim.x) {
        const long r = i / (F / 8);
        const int c = (int)(i % (F / 8)) * 8, e = (int)(r / lm), j = (int)(r % lm);
        *reinterpret_cast<uint4*>(w.sa + ((long)e * lq + 1 + j) * F + c) =
            *reinterpret_cast<const uint4*>(Vm + r * F + c);
      }
      clk.sync();
      small_gemm_phase<SE_PART>(
          SmallGemm{w.sa, F, nullptr, p.wco + (size_t)l * F * F, nullptr, nullptr, w.part, 1.0f, 0}, P.co, smem,
          &a.maps.sa, &a.maps.wco, l);
      clk.sync();
      small_ln_phase<false, false>(a, w.part, P.co.split, (long)R * F, Bco, nullptr, lns + F, lnb + F, smem);
    } else if (!full) {
      // identity band: the person rows attend their memory, the motion
      // rows take vmw in the cross LayerNorm
      small_gemm_phase<SE_PART>(
          SmallGemm{w.xb, F, a.rows, p.wcq + (size_t)l * F * F, nullptr, nullptr, w.ppart, 1.0f, 0}, P.cq, smem);
      clk.sync();
      for (int it = blockIdx.x; it < Be * H; it += gridDim.x) {
        const int e = it / H, h = it % H;
        if (entry)  // entry e's own memory rows
          person_block(w.ppart, P.cq.split, (long)Be * F, Bcq, scale, Km, Vm, (long)e * lm, lm, nullptr, w.pa, e, F,
                       e, h, smem);
        else  // the tile's memory rows through the person mask's row of e
          person_block(w.ppart, P.cq.split, (long)Be * F, Bcq, scale, Km, Vm, (long)(e / tile) * Mt, Mt,
                       a.cross_mask + (long)(e % tile) * Mt, w.pa, e, F, e, h, smem);
      }
      clk.sync();
      small_gemm_phase<SE_PART>(
          SmallGemm{w.pa, F, nullptr, p.wco + (size_t)l * F * F, nullptr, nullptr, w.ppart, 1.0f, 0}, P.co, smem);
      clk.sync();
      const size_t es = a.cross_f32 ? 4 : 2;
      const void* vmw = static_cast<const char*>(p.vmw) + (size_t)l * R * F * es;
      if (a.cross_f32)
        small_ln_phase<true, true>(a, w.ppart, P.co.split, (long)Be * F, Bco, vmw, lns + F, lnb + F, smem);
      else
        small_ln_phase<true, false>(a, w.ppart, P.co.split, (long)Be * F, Bco, vmw, lns + F, lnb + F, smem);
    } else {
      // full masked cross: every row attends the tile's memory
      small_gemm_phase<SE_PART>(
          SmallGemm{w.xb, F, nullptr, p.wcq + (size_t)l * F * F, nullptr, nullptr, w.part, 1.0f, 0}, P.cq, smem,
          &a.maps.xb, &a.maps.wcq, l);
      clk.sync();
      masked_phase(MaskedAttnArgs{nullptr, Km, Vm, F, F, F, a.cross_mask, w.sa, F, Rt, Mt, w.part, P.cq.split,
                                  (long)R * F, Bcq, scale, w.live_cross},
                   H, n_tiles, smem);
      clk.sync();
      small_gemm_phase<SE_PART>(
          SmallGemm{w.sa, F, nullptr, p.wco + (size_t)l * F * F, nullptr, nullptr, w.part, 1.0f, 0}, P.co, smem,
          &a.maps.sa, &a.maps.wco, l);
      clk.sync();
      small_ln_phase<false, false>(a, w.part, P.co.split, (long)R * F, Bco, nullptr, lns + F, lnb + F, smem);
    }
    clk.sync();

    // FFN
    small_gemm_phase<SE_GELU>(SmallGemm{w.xb, F, nullptr, p.wf1 + (size_t)l * F * FF, p.bf1 + (size_t)l * FF,
                                        nullptr, w.h, 1.0f, 0},
                              P.ffn1, smem, &a.maps.xb, &a.maps.wf1, l);
    clk.sync();
    small_gemm_phase<SE_PART>(
        SmallGemm{w.h, FF, nullptr, p.wf2 + (size_t)l * FF * F, nullptr, nullptr, w.part, 1.0f, 0}, P.ffn2, smem,
        &a.maps.h, &a.maps.wf2, l);
    clk.sync();
    small_ln_phase<false, false>(a, w.part, P.ffn2.split, (long)R * F, p.bf2 + (size_t)l * F, nullptr, lns + 2 * F,
                                 lnb + 2 * F, smem);
    if (!(end && l == a.L - 1) || clk.stamps != nullptr) clk.sync();
  }
}

}  // namespace
