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
// step embedding, the learnable PE), runs the decoder stack of
// decoder_common.cuh, then the motion decoder, the style-basis combine, the
// CFG mix over the E guidance entries and m <- A m + B target + sigma z.
// The two kernels round where their TPU kernels round:
// - K3 (at the TPU kernel's default switches: padded rows, f32 hoisted
//   vmw, concat row builds, no merged heads, no block-diagonal
//   self-attention): person and motion rows stay f32 into the first layer;
//   the cross output bf16(person_out) @ wco stays f32 and is added to the
//   f32 vmw (CROSS_F32). Rows are padded to a multiple of 16 inside the
//   attention kernel and the pad keys get no weight, which is what the TPU
//   kernel's pad rows and key mask compute.
// - K4: the person and motion rows are rounded to bf16 before the PE is
//   added (the TPU kernel places them with one-hot selector products), and
//   the cross output is [bf16(person_out) | memory V rows] @ wco over all
//   rows, with no vmw hoist (CROSS_GATHER). Its self-attention is flat
//   over the E*lq rows with a block-diagonal -1e30 mask, which gives
//   exactly zero weight across entries: the per-entry self-attention used
//   here computes the same thing, up to the order of f32 sums.
//
// What bounds it on an H100: at the flagship batch-1 shapes (E = 2 CFG
// entries of lq = 111 rows, F = 512, FFN 2048, 8 layers) a step is about
// 11.7 GFLOP of bf16 products against 59 MB of bf16 weights, which do not
// fit in the 50 MB L2: a window of 500 steps is ~5.9 ms of tensor-core
// work at 989 TFLOP/s and ~8.8 ms of weight traffic at 3.35 TB/s if the
// weights stream every step. At 222 rows every product is a handful of
// 64 x 128 tiles, so what bounds this design is latency: about 90 launches
// per step, each too small to fill the 132 SMs.
//
// Design, simple first: one C call per window (K3) or per step (K4)
// enqueues every launch on the caller's stream with no synchronisation;
// per-step inputs (step embedding, [A, B, sigma], noise) are indexed by
// step from device tables. A step is one prologue kernel, the 8 layers
// through the decoder sub-kernels, the first motion-decoder product as a
// GEMM that gathers the tail rows and fuses bias and tanh-GELU, and one
// epilogue kernel (second motion-decoder product, bias, style-basis
// combine, CFG mix, DDPM update in place on the carry). Not yet done: a
// persistent kernel or a replayed CUDA graph that removes the launch gaps.

#include "decoder_common.cuh"

namespace {

// Index of each pointer in the `ptrs` array both entry points take.
enum Ptr {
  P_WQKV, P_BQKV, P_WSO, P_BSO, P_WCQ, P_BCQ, P_WCO, P_BCO, P_WF1, P_BF1, P_WF2, P_BF2, P_LN_SCALE, P_LN_BIAS,
  P_KMEM, P_VMEM, P_VMW,
  P_PREV_ROWS, P_IND_COL, P_WFP, P_BFP, P_PERSONS_PRE, P_PE_FLAT,
  P_WD1, P_BD1, P_WD2, P_BD2, P_STATICS_ROWS, P_POSE_SUM_ROWS, P_COEF,
  P_EMB, P_SC, P_Z, P_MOTION, P_OUT, P_WS, P_ROWS, P_TAIL_ROWS,
  N_PTRS
};
// Index of each size in the `dims` array.
enum Dim { D_E, D_LQ, D_F, D_H, D_L, D_FF, D_N, D_D, D_K, D_FD, D_USE_IND, D_SIGMOID, D_T, N_DIMS };

constexpr int STEP_THREADS = 256;

// The token rows of every entry: row e*lq is persons_pre[e] + emb, row
// e*lq + 1 + i is bf16(rows[i]) @ wfp + bfp, each plus its PE row, where
// rows = [prev_rows; m | ind_col] (lm, Din). ROUND (K4) rounds the person
// and motion values to bf16 before the PE is added. One block per row j.
template <bool ROUND>
__global__ void __launch_bounds__(STEP_THREADS)
    prologue_kernel(const float* m, const float* __restrict__ prev_rows, const float* __restrict__ ind_col,
                    const bf16* __restrict__ wfp, const float* __restrict__ bfp,
                    const float* __restrict__ persons_pre, const float* __restrict__ emb,
                    const float* __restrict__ pe, float* __restrict__ x, bf16* __restrict__ xb, int E, int lq,
                    int P, int D, int F, int use_ind) {
  extern __shared__ float row[];  // Din
  const int j = blockIdx.x, Din = D + use_ind;
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

// One block per motion row i: dec = hdec @ wd2 + bd2 for every entry (the
// alphas through a sigmoid when asked), then the face channels take the
// alpha-weighted statics and the 3 head-pose channels the plain static
// sum, the entries are mixed with the CFG coefficients, and
// m_out = A m_in + B target + sigma z. m_in and m_out may be one buffer.
__global__ void __launch_bounds__(STEP_THREADS)
    epilogue_kernel(const bf16* __restrict__ hdec, const bf16* __restrict__ wd2, const float* __restrict__ bd2,
                    const float* __restrict__ statics_rows, const float* __restrict__ pose_sum_rows,
                    const float* __restrict__ coef, const float* __restrict__ sc, const float* __restrict__ z,
                    const float* m_in, float* m_out, int E, int N, int D, int K, int Fd, int sigmoid_alpha) {
  extern __shared__ float esm[];
  const int i = blockIdx.x, DK = D + K;
  float* hs = esm;           // (E, Fd)
  float* dec = hs + E * Fd;  // (E, D + K)
  for (int idx = threadIdx.x; idx < E * Fd; idx += blockDim.x) {
    const int e = idx / Fd, k = idx % Fd;
    hs[idx] = __bfloat162float(hdec[((long)e * N + i) * Fd + k]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < E * DK; idx += blockDim.x) {
    const int e = idx / DK, c = idx % DK;
    float acc = 0.0f;
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

struct SamplerScratch {
  Workspace dec;
  float* x;    // (E*lq, F)
  bf16* hdec;  // (E*N, Fd)
};

SamplerScratch carve_sampler(void* ws, const int* d, size_t* total) {
  SamplerScratch s;
  size_t off = 0;
  s.dec = carve(ws, d[D_E], d[D_LQ], d[D_F], d[D_FF], &off);
  char* p = static_cast<char*>(ws);
  s.x = p ? reinterpret_cast<float*>(p + off) : nullptr;
  off += align256((size_t)d[D_E] * d[D_LQ] * d[D_F] * 4);
  s.hdec = p ? reinterpret_cast<bf16*>(p + off) : nullptr;
  off += align256((size_t)d[D_E] * d[D_N] * d[D_FD] * 2);
  *total = off;
  return s;
}

bool sampler_shapes_ok(const int* d) {
  const int P = d[D_LQ] - 1 - d[D_N];
  return decoder_shapes_ok(d[D_LQ], d[D_F], d[D_H], d[D_FF]) && d[D_FD] % BN == 0 && d[D_D] >= 3 && P >= 0 &&
         d[D_T] >= 1 && d[D_E] >= 1 && d[D_K] >= 0;
}

// T steps of the sampler. SCAN: K3 (carry in p[P_OUT], per-step tables
// indexed by step, CROSS_F32); otherwise K4 (one step from p[P_MOTION]
// into p[P_OUT], rows rounded to bf16, CROSS_GATHER).
template <bool SCAN>
cudaError_t run_steps(void* const* p, const int* d, cudaStream_t st) {
  if (!sampler_shapes_ok(d) || (!SCAN && d[D_T] != 1)) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(set_kernel_attributes());
  const int E = d[D_E], lq = d[D_LQ], F = d[D_F], H = d[D_H], L = d[D_L], FF = d[D_FF], N = d[D_N];
  const int D = d[D_D], K = d[D_K], Fd = d[D_FD], use_ind = d[D_USE_IND], T = d[D_T];
  const int P = lq - 1 - N, Din = D + use_ind;
  size_t total = 0;
  const SamplerScratch s = carve_sampler(p[P_WS], d, &total);
  auto bf = [&](int i) { return static_cast<const bf16*>(p[i]); };
  auto f32 = [&](int i) { return static_cast<const float*>(p[i]); };
  const DecoderWeights w{bf(P_WQKV), bf(P_BQKV), bf(P_WSO), bf(P_BSO), bf(P_WCQ), bf(P_BCQ), bf(P_WCO),
                         bf(P_BCO),  bf(P_WF1),  bf(P_BF1), bf(P_WF2), bf(P_BF2), f32(P_LN_SCALE),
                         f32(P_LN_BIAS), bf(P_KMEM), bf(P_VMEM), p[P_VMW]};
  const int* rows = static_cast<const int*>(p[P_ROWS]);
  const int* tail_rows = static_cast<const int*>(p[P_TAIL_ROWS]);
  float* out = static_cast<float*>(p[P_OUT]);
  const float* m_in = SCAN ? out : f32(P_MOTION);
  if (SCAN) RETURN_IF_ERROR(cudaMemcpyAsync(out, p[P_MOTION], (size_t)N * D * 4, cudaMemcpyDeviceToDevice, st));
  const size_t epi_smem = (size_t)E * (Fd + D + K) * sizeof(float);

  for (int step = 0; step < T; ++step) {
    prologue_kernel<!SCAN><<<lq, STEP_THREADS, Din * sizeof(float), st>>>(
        m_in, f32(P_PREV_ROWS), f32(P_IND_COL), bf(P_WFP), f32(P_BFP), f32(P_PERSONS_PRE),
        f32(P_EMB) + (size_t)step * F, f32(P_PE_FLAT), s.x, s.dec.xb, E, lq, P, D, F, use_ind);
    RETURN_IF_ERROR(cudaGetLastError());
    RETURN_IF_ERROR(decoder_layers(st, s.dec, s.x, w, rows, E, lq, F, H, L, FF, SCAN ? CROSS_F32 : CROSS_GATHER));
    RETURN_IF_ERROR(gemm<EPI_GELU>(st, s.dec.xb, F, tail_rows, bf(P_WD1), nullptr, nullptr, s.hdec, E * N, Fd, F,
                                   1.0f, 0, f32(P_BD1)));
    epilogue_kernel<<<N, STEP_THREADS, epi_smem, st>>>(
        s.hdec, bf(P_WD2), f32(P_BD2), f32(P_STATICS_ROWS), f32(P_POSE_SUM_ROWS), f32(P_COEF),
        f32(P_SC) + (size_t)step * 8, f32(P_Z) + (size_t)step * N * D, m_in, out, E, N, D, K, Fd,
        d[D_SIGMOID]);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int msmd_sampler_n_ptrs() { return N_PTRS; }
extern "C" int msmd_sampler_n_dims() { return N_DIMS; }

extern "C" size_t msmd_sampler_workspace_bytes(const int* dims) {
  size_t total = 0;
  carve_sampler(nullptr, dims, &total);
  return total;
}

// ptrs: the N_PTRS device pointers in `Ptr` order; dims: the N_DIMS sizes
// in `Dim` order. Launches on `stream`; returns the first CUDA error or 0.
extern "C" int msmd_sampler_scan(void* const* ptrs, const int* dims, void* stream) {
  return run_steps<true>(ptrs, dims, static_cast<cudaStream_t>(stream));
}

extern "C" int msmd_sampler_step(void* const* ptrs, const int* dims, void* stream) {
  return run_steps<false>(ptrs, dims, static_cast<cudaStream_t>(stream));
}
