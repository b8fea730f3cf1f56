// The batch-1 DDPM sampler of MSMD, hand-written for Hopper (sm_90a) and
// bound to PyTorch through a plain C interface (ctypes). Two entry points:
//
// msmd_sampler_scan (K3) replaces msmd_tpu/ops/pallas/decoder_kernel.py::
//   fused_sampler_scan (body _sampler_scan_kernel): all T reverse-diffusion
//   steps of one window in one call, the motion carry held in f32 on the
//   device from step to step.
// msmd_sampler_step (K4) replaces decoder_kernel.py::fused_sampler_step
//   (body _sampler_step_kernel): one such step, used for trajectories.
//
// A step builds the token rows (the feature projection of the previous and
// the noisy motion with its indicator channel, the person token plus the
// step embedding, the learnable PE), runs the decoder stack, then the
// motion decoder, the style-basis combine, the
// CFG mix over the E guidance entries and m <- A m + B target + sigma z.
// The two kernels round where their TPU kernels round:
// - K3 (at the TPU kernel's default switches: padded rows, f32 hoisted
//   vmw, concat row builds, no merged heads, no block-diagonal
//   self-attention): person and motion rows stay f32 into the first layer;
//   the cross output bf16(person_out) @ wco stays f32 and is added to the
//   f32 vmw (decoder_small.cuh's cross_f32). Rows are padded to a multiple of 16 inside the
//   attention kernel and the pad keys get no weight, which is what the TPU
//   kernel's pad rows and key mask compute.
// - K4: the person and motion rows are rounded to bf16 before the PE is
//   added (the TPU kernel places them with one-hot selector products), and
//   the cross output is [bf16(person_out) | memory V rows] @ wco over all
//   rows, with no vmw hoist (decoder_small.cuh's SMALL_ENTRY_GATHER). Its
//   self-attention is flat over the E*lq rows with a block-diagonal -1e30
//   mask, which gives exactly zero weight across entries: the per-entry
//   self-attention used here computes the same thing, up to the order of
//   f32 sums.
//
// What bounds it on an H100: at the flagship batch-1 shapes (E = 2 CFG
// entries of lq = 111 rows, F = 512, FFN 2048, 8 layers) a step is about
// 11.7 GFLOP of bf16 products against 59 MB of bf16 weights, which do not
// fit in the 50 MB L2: a window of 500 steps is ~5.9 ms of tensor-core
// work at 989 TFLOP/s and ~8.8 ms of weight traffic at 3.35 TB/s if the
// weights stream every step. At 222 rows every product is a handful of
// tiles, so what bounds a chain of launches is latency: the earlier design
// (about 91 launches a step on grids of 4-64 blocks) took 1.7 ms a step.
//
// Design. K3 is the persistent small-row stack of decoder_small.cuh: a
// window is ONE cooperative launch whose phases are, for each step, the
// token rows, the 8 x 11 layer phases, the motion
// decoder's first product (split-K over the tail rows gathered from xb)
// and the epilogue (its sum of the split-K partials, bias and tanh-GELU,
// the second product, the style-basis combine, the CFG mix and the DDPM
// update in place on the f32 carry). Every phase is cut into about as many
// items as the grid has blocks. Per-step inputs (step embedding, [A, B,
// sigma], noise) are indexed by step from device tables, and one C call
// runs the window. (A launch a step took 281.1 ms a window on an H100,
// 2% more than one launch a window.) K4 is one step of the same stack, one
// cooperative launch (step_kernel): K3's phases with T = 1, K4's rounded
// token rows, and its gathered cross output over every row as a wco phase
// on the 64 x 64 wgmma tile (split-K). Its chain of ~99 launches a step
// through decoder_common.cuh::decoder_layers took 1.97 ms a step on an
// H100 (PERF.md).

#include "decoder_small.cuh"

namespace {

// Index of each pointer in the `ptrs` array both entry points take.
enum Ptr {
  P_WQKV, P_BQKV, P_WSO, P_BSO, P_WCQ, P_BCQ, P_WCO, P_BCO, P_WF1, P_BF1, P_WF2, P_BF2, P_LN_SCALE, P_LN_BIAS,
  P_KMEM, P_VMEM, P_VMW,
  P_PREV_ROWS, P_IND_COL, P_WFP, P_BFP, P_PERSONS_PRE, P_PE_FLAT,
  P_WD1, P_BD1, P_WD2, P_BD2, P_STATICS_ROWS, P_POSE_SUM_ROWS, P_COEF,
  P_EMB, P_SC, P_Z, P_MOTION, P_OUT, P_WS, P_ROWS, P_TAIL_ROWS, P_STAMPS,
  N_PTRS
};
// Index of each size in the `dims` array.
// D_GRID: the cooperative grid (0: all that fit on the card).
enum Dim { D_E, D_LQ, D_F, D_H, D_L, D_FF, D_N, D_D, D_K, D_FD, D_USE_IND, D_SIGMOID, D_T, D_GRID, N_DIMS };

// The token rows of every entry: row e*lq is persons_pre[e] + emb, row
// e*lq + 1 + i is bf16(rows[i]) @ wfp + bfp, each plus its PE row, where
// rows = [prev_rows; m | ind_col] (lm, Din). ROUND (K4) rounds the person
// and motion values to bf16 before the PE is added. Row j by the whole
// block, in `row` (Din floats of shared memory).
template <bool ROUND>
__device__ __forceinline__ void prologue_row(int j, const float* m, const float* __restrict__ prev_rows,
                                             const float* __restrict__ ind_col, const bf16* __restrict__ wfp,
                                             const float* __restrict__ bfp, const float* __restrict__ persons_pre,
                                             const float* __restrict__ emb, const float* __restrict__ pe,
                                             float* __restrict__ x, bf16* __restrict__ xb, int E, int lq, int P,
                                             int D, int F, int use_ind, float* row) {
  const int Din = D + use_ind;
  __syncthreads();  // the block's previous item is done with `row`
  if (j > 0) {
    const int i = j - 1;
    for (int k = threadIdx.x; k < Din; k += blockDim.x) {
      const float v = i < P ? prev_rows[(long)i * Din + k] : (k < D ? m[(long)(i - P) * D + k] : ind_col[i - P]);
      row[k] = round_bf16(v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < F; c += blockDim.x) {
    float f = 0.0f;
    if (j > 0) {
#pragma unroll 4
      for (int k = 0; k < Din; ++k) f += row[k] * __bfloat162float(wfp[(long)k * F + c]);
      f += bfp[c];
      if (ROUND) f = round_bf16(f);
    }
    for (int e = 0; e < E; ++e) {
      if (j == 0) {
        f = persons_pre[(long)e * F + c] + emb[c];
        if (ROUND) f = round_bf16(f);
      }
      const long o = ((long)e * lq + j) * F + c;
      const float v = f + pe[o];
      x[o] = v;
      xb[o] = __float2bfloat16(v);
    }
  }
}

// Motion row i by the whole block, in `esm` (E * (Fd + D + K) floats of
// shared memory): the motion decoder's first product comes as f32 split-K
// partials hpart (S, E*N, Fd), and hdec = bf16(gelu_tanh(their sum + bd1))
// is formed here; dec = hdec @ wd2 + bd2 for every entry (the alphas
// through a sigmoid when asked), then the face channels take the
// alpha-weighted statics and the 3 head-pose channels the plain static
// sum, the entries are mixed with the CFG coefficients, and m_out = A m_in
// + B target + sigma z. m_in and m_out may be one buffer.
__device__ __forceinline__ void epilogue_row(int i, const float* __restrict__ hpart, int S,
                                             const float* __restrict__ bd1, const bf16* __restrict__ wd2,
                                             const float* __restrict__ bd2, const float* __restrict__ statics_rows,
                                             const float* __restrict__ pose_sum_rows,
                                             const float* __restrict__ coef, const float* __restrict__ sc,
                                             const float* __restrict__ z, const float* m_in, float* m_out, int E,
                                             int N, int D, int K, int Fd, int sigmoid_alpha, float* esm) {
  const int DK = D + K;
  float* hs = esm;           // (E, Fd)
  float* dec = hs + E * Fd;  // (E, D + K)
  __syncthreads();  // the block's previous item is done with esm
  for (int idx = threadIdx.x; idx < E * Fd; idx += blockDim.x) {
    const int e = idx / Fd, k = idx % Fd;
    const long o = ((long)e * N + i) * Fd + k;
    hs[idx] = round_bf16(gelu_tanh(part_sum(hpart, S, (long)E * N * Fd, o) + bd1[k]));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < E * DK; idx += blockDim.x) {
    const int e = idx / DK, c = idx % DK;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < Fd; ++k) acc += hs[e * Fd + k] * __bfloat162float(wd2[(long)k * DK + c]);
    float v = acc + bd2[c];
    if (c >= D && sigmoid_alpha) v = 1.0f / (1.0f + expf(-v));
    dec[idx] = v;
  }
  __syncthreads();
  const float A = sc[0], Bc = sc[1], sg = sc[2];
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float target = 0.0f;
    for (int e = 0; e < E; ++e) {
      const long r = (long)e * N + i;
      float o = dec[e * DK + d];
      if (d < D - 3) {
        for (int kb = 0; kb < K; ++kb) o = o + dec[e * DK + D + kb] * statics_rows[((long)kb * E * N + r) * D + d];
      } else {
        o = o + pose_sum_rows[r * 3 + d - (D - 3)];
      }
      target = target + coef[e] * o;
    }
    const long o = (long)i * D + d;
    m_out[o] = A * m_in[o] + Bc * target + sg * z[o];
  }
}

bool sampler_shapes_ok(const int* d) {
  const int P = d[D_LQ] - 1 - d[D_N];
  return decoder_shapes_ok(d[D_LQ], d[D_F], d[D_H], d[D_FF]) && d[D_FD] % BN == 0 && d[D_D] >= 3 && P >= 0 &&
         d[D_T] >= 1 && d[D_E] >= 1 && d[D_K] >= 0;
}

// ---------------------------------------------------------------------------
// K3: the persistent small-row stack of decoder_small.cuh, the T steps of
// the window in one cooperative launch
// ---------------------------------------------------------------------------

struct ScanArgs {
  SmallArgs d;
  const float *prev_rows, *ind_col, *bfp, *persons_pre, *pe, *bd1, *bd2, *statics_rows, *pose_sum_rows, *coef;
  const bf16 *wfp, *wd1, *wd2;
  const float *emb, *sc, *z;  // per-step tables (T, F), (T, 8), (T, N, D)
  float* out;                 // the f32 motion carry (N, D); K4's output
  const float* m_in;          // K4: the step's input motion (N, D)
  const int* tail_rows;       // (E*N,) rows e*lq + 1 + P + i
  int E, N, D, K, Fd, P, use_ind, sigmoid_alpha, T;
};

__device__ __forceinline__ void scan_prologue_row(const ScanArgs& a, int j, int step, unsigned char* smem) {
  prologue_row<false>(j, a.out, a.prev_rows, a.ind_col, a.wfp, a.bfp, a.persons_pre, a.emb + (size_t)step * a.d.F,
                      a.pe, a.d.x, a.d.w.xb, a.E, a.d.lq, a.P, a.D, a.d.F, a.use_ind, reinterpret_cast<float*>(smem));
}

// A step: the token rows | the L layers (11 phases each) | the motion
// decoder's first product (split-K) | the epilogue rows. Before every step
// but the last, the epilogue phase also builds the next step's
// token rows: the block that updates motion row i builds token row 1 + P
// + i from it, and the other blocks the person and previous-motion rows,
// which do not read the carry, so no barrier separates them.
__global__ void __launch_bounds__(SMALL_THREADS, SMALL_MIN_BLOCKS) scan_kernel(const __grid_constant__ ScanArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmallArgs& d = a.d;
  PhaseClock clk{d.stamps, 0};
  clk.start();
  const int lq = d.lq, N = a.N, P = a.P;
  for (int j = blockIdx.x; j < lq; j += gridDim.x) scan_prologue_row(a, j, 0, smem);
  clk.sync();
  for (int step = 0; step < a.T; ++step) {
    small_layers(d, clk, smem, false);
    small_gemm_phase<SE_PART>(SmallGemm{d.w.xb, d.F, a.tail_rows, a.wd1, nullptr, nullptr, d.w.hpart, 1.0f, 0},
                              d.plan.md, smem);
    clk.sync();
    const bool next = step + 1 < a.T;
    const int items = next ? N + P + 1 : N;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      if (i < N) {
        epilogue_row(i, d.w.hpart, d.plan.md.split, a.bd1, a.wd2, a.bd2, a.statics_rows, a.pose_sum_rows, a.coef,
                     a.sc + (size_t)step * 8, a.z + (size_t)step * N * a.D, a.out, a.out, a.E, N, a.D, a.K, a.Fd,
                     a.sigmoid_alpha, reinterpret_cast<float*>(smem));
        if (next) {
          __syncthreads();  // row i of the carry, written by this block, is visible to all of it
          scan_prologue_row(a, 1 + P + i, step + 1, smem);
        }
      } else {
        scan_prologue_row(a, i - N, step + 1, smem);
      }
    }
    if (next || clk.stamps != nullptr) clk.sync();
  }
}

// K4: one step of K3's phases on the same stack with K4's rounding: the
// token rows rounded to bf16 before the PE (from the input motion m_in) |
// the L layers in SMALL_ENTRY_GATHER mode (the gathered cross output over
// every row) | the motion decoder's first product (split-K) | the
// epilogue rows, written to out.
__global__ void __launch_bounds__(SMALL_THREADS, SMALL_MIN_BLOCKS) step_kernel(const __grid_constant__ ScanArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmallArgs& d = a.d;
  PhaseClock clk{d.stamps, 0};
  clk.start();
  for (int j = blockIdx.x; j < d.lq; j += gridDim.x)
    prologue_row<true>(j, a.m_in, a.prev_rows, a.ind_col, a.wfp, a.bfp, a.persons_pre, a.emb, a.pe, d.x, d.w.xb, a.E,
                       d.lq, a.P, a.D, d.F, a.use_ind, reinterpret_cast<float*>(smem));
  clk.sync();
  small_layers(d, clk, smem, false);
  small_gemm_phase<SE_PART>(SmallGemm{d.w.xb, d.F, a.tail_rows, a.wd1, nullptr, nullptr, d.w.hpart, 1.0f, 0},
                            d.plan.md, smem);
  clk.sync();
  for (int i = blockIdx.x; i < a.N; i += gridDim.x)
    epilogue_row(i, d.w.hpart, d.plan.md.split, a.bd1, a.wd2, a.bd2, a.statics_rows, a.pose_sum_rows, a.coef, a.sc,
                 a.z, a.m_in, a.out, a.E, a.N, a.D, a.K, a.Fd, a.sigmoid_alpha, reinterpret_cast<float*>(smem));
  if (clk.stamps != nullptr) clk.sync();
}

bool scan_attr_set = false, step_attr_set = false;

int scan_fit() { return small_grid(scan_kernel, &scan_attr_set); }
int step_fit() { return small_grid(step_kernel, &step_attr_set); }

SmallPlan scan_plan(const int* d, int grid) {
  return make_small_plan(SMALL_ENTRY, d[D_E], d[D_LQ], d[D_F], d[D_FF], grid, d[D_E] * d[D_N], d[D_FD]);
}
SmallPlan step_plan(const int* d, int grid) {
  return make_small_plan(SMALL_ENTRY_GATHER, d[D_E], d[D_LQ], d[D_F], d[D_FF], grid, d[D_E] * d[D_N], d[D_FD]);
}

bool scan_shapes_ok(const int* d) {
  const size_t Din = d[D_D] + d[D_USE_IND];
  return sampler_shapes_ok(d) && small_shapes_ok(d[D_LQ], d[D_F], d[D_H], d[D_FF]) && d[D_FD] % SB_BN == 0 &&
         Din * sizeof(float) <= SMALL_SMEM &&
         (size_t)d[D_E] * (d[D_FD] + d[D_D] + d[D_K]) * sizeof(float) <= SMALL_SMEM;
}

// The arguments of K3's and K4's kernels from the C entry points' pointer
// and size lists, on `plan`.
ScanArgs scan_args(void* const* p, const int* d, const SmallPlan& plan) {
  const int E = d[D_E], lq = d[D_LQ], F = d[D_F], N = d[D_N];
  auto bf = [&](int i) { return static_cast<const bf16*>(p[i]); };
  auto f32 = [&](int i) { return static_cast<const float*>(p[i]); };
  ScanArgs a;
  a.d.plan = plan;
  size_t total = 0;
  a.d.w = carve_small(p[P_WS], a.d.plan, E, lq, F, d[D_FF], 0, true, &total);
  a.d.x = a.d.w.x;
  a.d.x_in = nullptr;
  a.d.p = DecoderWeights{bf(P_WQKV), bf(P_BQKV), bf(P_WSO), bf(P_BSO), bf(P_WCQ), bf(P_BCQ), bf(P_WCO),
                         bf(P_BCO),  bf(P_WF1),  bf(P_BF1), bf(P_WF2), bf(P_BF2), f32(P_LN_SCALE),
                         f32(P_LN_BIAS), bf(P_KMEM), bf(P_VMEM), p[P_VMW]};
  a.d.rows = static_cast<const int*>(p[P_ROWS]);
  a.d.self_mask = a.d.cross_mask = nullptr;
  a.d.cross_f32 = plan.mode == SMALL_ENTRY;
  a.d.Be = E;
  a.d.lq = lq;
  a.d.F = F;
  a.d.H = d[D_H];
  a.d.L = d[D_L];
  a.d.FF = d[D_FF];
  a.d.tile = 0;
  a.prev_rows = f32(P_PREV_ROWS);
  a.ind_col = f32(P_IND_COL);
  a.bfp = f32(P_BFP);
  a.persons_pre = f32(P_PERSONS_PRE);
  a.pe = f32(P_PE_FLAT);
  a.bd1 = f32(P_BD1);
  a.bd2 = f32(P_BD2);
  a.statics_rows = f32(P_STATICS_ROWS);
  a.pose_sum_rows = f32(P_POSE_SUM_ROWS);
  a.coef = f32(P_COEF);
  a.wfp = bf(P_WFP);
  a.wd1 = bf(P_WD1);
  a.wd2 = bf(P_WD2);
  a.emb = f32(P_EMB);
  a.sc = f32(P_SC);
  a.z = f32(P_Z);
  a.out = static_cast<float*>(p[P_OUT]);
  a.m_in = f32(P_MOTION);
  a.tail_rows = static_cast<const int*>(p[P_TAIL_ROWS]);
  a.E = E;
  a.N = N;
  a.D = d[D_D];
  a.K = d[D_K];
  a.Fd = d[D_FD];
  a.P = lq - 1 - N;
  a.use_ind = d[D_USE_IND];
  a.sigmoid_alpha = d[D_SIGMOID];
  a.T = d[D_T];
  a.d.stamps = static_cast<unsigned long long*>(p[P_STAMPS]);
  return a;
}

// All T steps of K3 (the carry in p[P_OUT], per-step tables indexed by
// step, the f32 cross output) in one cooperative launch.
cudaError_t run_scan(void* const* p, const int* d, cudaStream_t st) {
  if (!scan_shapes_ok(d)) return cudaErrorInvalidValue;
  int grid = 0;
  RETURN_IF_ERROR(small_launch_grid(scan_fit(), d[D_GRID], &grid));
  ScanArgs a = scan_args(p, d, scan_plan(d, grid));
  RETURN_IF_ERROR(make_small_maps(&a.d.maps, a.d.w, a.d.p, d[D_E] * d[D_LQ], d[D_F], d[D_FF], d[D_L]));
  RETURN_IF_ERROR(cudaMemcpyAsync(a.out, p[P_MOTION], (size_t)d[D_N] * d[D_D] * 4, cudaMemcpyDeviceToDevice, st));
  void* args[] = {&a};
  RETURN_IF_ERROR(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(scan_kernel), dim3(grid), dim3(SMALL_THREADS),
                                              args, SMALL_SMEM, st));
  return cudaGetLastError();
}

// One step of K4 (T = 1: the tables hold that step's rows) in one
// cooperative launch: p[P_MOTION] in, p[P_OUT] out.
cudaError_t run_step(void* const* p, const int* d, cudaStream_t st) {
  if (!scan_shapes_ok(d) || d[D_T] != 1) return cudaErrorInvalidValue;
  int grid = 0;
  RETURN_IF_ERROR(small_launch_grid(step_fit(), d[D_GRID], &grid));
  ScanArgs a = scan_args(p, d, step_plan(d, grid));
  RETURN_IF_ERROR(make_small_maps(&a.d.maps, a.d.w, a.d.p, d[D_E] * d[D_LQ], d[D_F], d[D_FF], d[D_L]));
  void* args[] = {&a};
  RETURN_IF_ERROR(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(step_kernel), dim3(grid), dim3(SMALL_THREADS),
                                              args, SMALL_SMEM, st));
  return cudaGetLastError();
}

// K3's (step 0) or K4's (step 1) plan on the current device, as
// msmd_scan_plan gives it.
int sampler_plan(const int* dims, int step, long* out) {
  if (!scan_shapes_ok(dims) || (step && dims[D_T] != 1)) return cudaErrorInvalidValue;
  int grid = 0;
  const int fit = step ? step_fit() : scan_fit();
  RETURN_IF_ERROR(small_launch_grid(fit, dims[D_GRID], &grid));
  int dev = 0, sms = 0;
  RETURN_IF_ERROR(cudaGetDevice(&dev));
  RETURN_IF_ERROR(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  out[0] = grid;
  out[1] = fit / sms;
  out[2] = SMALL_SMEM;
  out[3] = small_phases(step ? step_plan(dims, grid) : scan_plan(dims, grid), dims[D_E], dims[D_LQ], dims[D_H],
                        dims[D_L], 0, dims[D_E] * dims[D_N], dims[D_N], out + 4);
  return 0;
}

}  // namespace

extern "C" int msmd_sampler_n_ptrs() { return N_PTRS; }
extern "C" int msmd_sampler_n_dims() { return N_DIMS; }

// Bytes of scratch either entry point takes at these sizes (its plan on
// the current device, D_GRID blocks), or 0 for sizes both refuse.
extern "C" size_t msmd_sampler_workspace_bytes(const int* dims) {
  size_t k3 = 0, k4 = 0;
  int grid = 0;
  if (!scan_shapes_ok(dims)) return 0;
  if (small_launch_grid(scan_fit(), dims[D_GRID], &grid) == cudaSuccess)
    carve_small(nullptr, scan_plan(dims, grid), dims[D_E], dims[D_LQ], dims[D_F], dims[D_FF], 0, true, &k3);
  if (small_launch_grid(step_fit(), dims[D_GRID], &grid) == cudaSuccess)
    carve_small(nullptr, step_plan(dims, grid), dims[D_E], dims[D_LQ], dims[D_F], dims[D_FF], 0, true, &k4);
  return k3 > k4 ? k3 : k4;
}

// K3's plan on the current device: out = {grid, blocks per SM, dynamic
// shared memory, phases, then 7 longs a phase (small_phases)}, room for
// 4 + 7 * (3 + 11 L) longs. Returns 0 or a CUDA error (shapes refused, no
// cooperative grid).
extern "C" int msmd_scan_plan(const int* dims, long* out) { return sampler_plan(dims, 0, out); }

// K4's plan (dims[D_T] = 1), as msmd_scan_plan's.
extern "C" int msmd_step_plan(const int* dims, long* out) { return sampler_plan(dims, 1, out); }

// ptrs: the N_PTRS device pointers in `Ptr` order (P_VMW null for K4,
// P_STAMPS null or room for the card's clock after every phase);
// dims: the N_DIMS sizes in `Dim` order. Launches on `stream`; returns the
// first CUDA error or 0.
extern "C" int msmd_sampler_scan(void* const* ptrs, const int* dims, void* stream) {
  return run_scan(ptrs, dims, static_cast<cudaStream_t>(stream));
}

extern "C" int msmd_sampler_step(void* const* ptrs, const int* dims, void* stream) {
  return run_step(ptrs, dims, static_cast<cudaStream_t>(stream));
}
