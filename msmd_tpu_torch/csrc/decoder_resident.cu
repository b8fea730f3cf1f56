// Layer-outer, activation-resident decoder stack of one MSMD DDPM sampler
// step, hand-written for Hopper (sm_90a), bound to PyTorch through a plain
// C interface (ctypes).
//
// Replaces the TPU kernel msmd_tpu/ops/pallas/decoder_kernel.py::
// fused_decoder_forward_resident (body _decoder_kernel_resident): K1's
// per-entry identity-band math (per-entry self-attention, the person rows'
// cross-attention, the hoisted projected V-gather `vmw`, FFN, three
// post-LNs) with the grid turned layer-outer, so that each layer's weights
// stream once per step while the whole batch's activations stay resident.
//
// On the TPU "resident" means one VMEM block holding all activations. On
// an H100 the design is one persistent cooperative launch per sampler
// step that runs all L layers: one block an SM, and each phase of a layer
// hands its work items (GEMM tiles, (entry, head) attention blocks, person
// rows, LayerNorm rows) to the blocks in a strided loop, with a grid-wide
// barrier between phases:
//
//   QKV GEMM | self-attention | out-proj + residual + LN1, and on the
//   motion rows the cross step (vmw + bco) and its LayerNorm | person-row
//   q GEMM | person attention | wco GEMM of the person rows | the person
//   rows' cross LayerNorm | FFN1 + GELU | FFN2 + residual + LN3
//
// (below SM90_MIN_ROWS rows the products are wmma tiles and the
// LayerNorms phases of their own, as in K1's chain). The work items are
// K1's own device functions, or K1's arithmetic in the same order
// (decoder_common.cuh and gemm_sm90.cuh: self_attn_block,
// person_attn_block, ln_row, the wmma gemm_tile), chosen by the same
// shape rules (sm90_wide_ok, sm90_ln_ok), so K2 computes the same bits as
// K1 and differs only in scheduling: 1 launch per step instead of 1 + 9
// per layer. Its wgmma products run on the 256-thread tile loop of
// gemm_sm90.cuh (sm90_tiles_loop), whose bits K1's warp-specialised
// pipeline keeps.
//
// Design for the card (PERF.md):
// - Registers by phase. Every phase but the Hopper GEMM's is an
//   out-of-line function, allocated its own registers: inlined into one
//   kernel, every phase ran at the worst phase's 255 (one 256-thread block
//   an SM) and the kernel spilled 1516 bytes. The Hopper GEMM's phases
//   stay inline, since ptxas serializes wgmma across a call. A 384-thread
//   variant with a TMA producer warpgroup (setmaxnreg 40) and two consumer
//   warpgroups (232) was compiled at the launch's 168 registers a thread
//   and spilled more.
// - No LayerNorm phase over all rows where the Hopper GEMM takes the
//   residual products: at one block an SM such a phase costs about 1.7x
//   K1's launch of it, so the self-out product's epilogue takes the
//   motion rows' cross step and its LayerNorm (EPI_RESID_LN_CROSS, which
//   K1 runs too, so the two stay bit-equal), and the cross LayerNorm phase
//   covers the Be person rows only.
// - No persisting L2 access-policy window: one over x and its bf16 copy
//   (32.7 MB at Be = 96) did not make K2 faster, and its persisting lines
//   stayed in the L2 after the call.
//
// What bounds it: the same ~537 GFLOP of bf16 products per step as K1
// (~0.54 ms at 989 TFLOP/s).

#include "decoder_small.cuh"  // decoder_common.cuh, cooperative groups and PhaseClock

namespace {

// Shared memory: the largest phase's (the Hopper GEMM's 64 x 512 ring
// with its alignment slack, LayerNorm partials and mbarriers; the
// self-attention's Q, K and V; the wmma ring; the person rows' scores).
constexpr size_t RES_SMEM =
    cmax(cmax(cmax(Sm90Tile<1>::SMEM, Sm90Tile<2>::SMEM), cmax(gemm_smem_bytes<128>(), gemm_smem_bytes<64>())),
         cmax((size_t)3 * MAX_LM * 128, (size_t)(GEMM_THREADS / 32) * (DH + MAX_LM) * sizeof(float)));

struct ResidentArgs {
  DecoderMaps maps;  // the Hopper products' tensor maps (built where decoder_uses_sm90)
  const float* x_in;
  float* x;  // (R, F) f32 activations, the result
  Workspace w;
  DecoderWeights p;
  const int* rows;  // (Be,) person rows e*lq
  int Be, lq, F, H, L, FF;
  unsigned long long* stamps;  // optional: the card's clock after every grid barrier
};

// The phases. Every phase but the Hopper GEMM's is an out-of-line
// function, so that its registers are its own: inlined into one kernel,
// every phase ran at the 255 registers of the worst (the Hopper GEMM's
// 64 x 512 LayerNorm tiles) and the kernel spilled 1516 bytes. The Hopper
// GEMM's phases stay inline: ptxas serializes wgmma across a call.

// Every tile of one product on the Hopper GEMM's 256-thread tile loop
// (the bits of K1's products).
template <int EPI>
__device__ __forceinline__ void sm90_phase(const Sm90Args& g, unsigned char* smem) {
  sm90_tiles_loop<EPI>(g, smem);
}

// Every wmma tile of one product (the person rows', and every product
// below SM90_MIN_ROWS rows), strided over the blocks. The tile height
// follows gemm() in decoder_common.cuh (128 rows for N > 512).
template <int EPI>
__device__ __noinline__ void wmma_phase(const GemmArgs g, unsigned char* smem) {
  const int tn = g.N / BN;
  if (g.N > 512) {
    const int n = tn * ((g.M + 127) / 128);
    for (int i = blockIdx.x; i < n; i += gridDim.x) gemm_tile<EPI, 128>(g, i / tn, i % tn, smem);
  } else {
    const int n = tn * ((g.M + 63) / 64);
    for (int i = blockIdx.x; i < n; i += gridDim.x) gemm_tile<EPI, 64>(g, i / tn, i % tn, smem);
  }
}

// LayerNorm rows, a warp a row, into x and xb. Only where
// the Hopper GEMM does not take the residual products (below SM90_MIN_ROWS
// rows) does a LayerNorm phase run over all rows: at one block an SM the
// cross LayerNorm over all 10656 rows of Be = 96 took 117 us against 70-80
// us at K1's grid of a block per 8 rows (PERF.md), which is why the motion
// rows' cross step rides in the self-out product's epilogue.
template <bool CROSS>
__device__ __noinline__ void ln_phase(const ResidentArgs& a, const float* y, const float* scale,
                                      const float* bias, const bf16* vmw, const bf16* bco) {
  constexpr int WARPS = GEMM_THREADS / 32;
  for (int row = blockIdx.x * WARPS + threadIdx.x / 32; row < a.Be * a.lq; row += gridDim.x * WARPS)
    ln_row<CROSS, bf16>(row, threadIdx.x % 32, y, a.x, a.w.xb, scale, bias, a.F, static_cast<const bf16*>(a.w.po),
                        vmw, bco, a.rows, a.lq);
}

// The per-entry self-attention, an (entry, head) item a block at a time:
// K1's self_attn_block. (Copying the next item while one computes, or
// two items a block with two query tiles a warp, did not make it faster
// on the card.)
__device__ __noinline__ void self_attn_phase(const ResidentArgs& a, unsigned char* smem) {
  for (int i = blockIdx.x; i < a.Be * a.H; i += gridDim.x)
    self_attn_block(a.w.qkv, a.w.sa, a.lq, a.F, i % a.H, i / a.H, smem);
}

// The cross LayerNorm of the person rows alone, a warp a row (where the
// self-out product's epilogue took the motion rows').
__device__ __noinline__ void person_ln_phase(const ResidentArgs& a, const float* scale, const float* bias,
                                             const bf16* vmw, const bf16* bco) {
  constexpr int WARPS = GEMM_THREADS / 32;
  for (int e = blockIdx.x * WARPS + threadIdx.x / 32; e < a.Be; e += gridDim.x * WARPS)
    ln_row<true, bf16>(a.rows[e], threadIdx.x % 32, nullptr, a.x, a.w.xb, scale, bias, a.F,
                       static_cast<const bf16*>(a.w.po), vmw, bco, a.rows, a.lq);
}

// The person rows' attention, a block an entry.
__device__ __noinline__ void person_phase(const ResidentArgs& a, const bf16* Km, const bf16* Vm,
                                          unsigned char* smem) {
  for (int e = blockIdx.x; e < a.Be; e += gridDim.x) {
    __syncthreads();
    person_attn_block(a.w.qp, Km, Vm, a.w.pa, a.lq - 1, a.F, a.H, e, reinterpret_cast<float*>(smem));
  }
}

// QKV or FFN1 (bf16 out): the Hopper GEMM where it takes the shape, as
// gemm_bf16_out chooses in K1, else the wmma tiles.
template <int EPI>
__device__ __forceinline__ void bf16_out_phase(const GemmArgs& g, const CUtensorMap* ma, const CUtensorMap* mb,
                                               int layer, unsigned char* smem) {
  if (sm90_wide_ok(g.M, g.N, g.K))
    sm90_phase<EPI>(Sm90Args{ma, mb, layer, g.bias, nullptr, g.C, nullptr, nullptr, nullptr, g.M, g.N, g.K, g.scale,
                             g.scale_cols},
                    smem);
  else
    wmma_phase<EPI>(g, smem);
}

// x, xb = LayerNorm(x + A @ B + bias) with its grid barriers: the
// Hopper GEMM's LayerNorm epilogue where it takes the shape (as
// gemm_resid_ln chooses in K1), else the wmma tiles into y and a LayerNorm
// phase.
__device__ __forceinline__ void resid_ln_phase(const ResidentArgs& a, PhaseClock& clk, const CUtensorMap* ma,
                                               const CUtensorMap* mb, int layer, const bf16* A, long lda,
                                               const bf16* B, const bf16* bias, int K, const float* lns,
                                               const float* lnb, unsigned char* smem) {
  const int R = a.Be * a.lq, F = a.F;
  if (sm90_ln_ok(R, F, K)) {
    sm90_phase<EPI_RESID_LN>(Sm90Args{ma, mb, layer, bias, a.x, a.x, a.w.xb, lns, lnb, R, F, K, 1.0f, 0}, smem);
  } else {
    wmma_phase<EPI_RESID>(GemmArgs{A, lda, nullptr, B, bias, nullptr, a.x, a.w.y, R, F, K, 1.0f, 0, nullptr}, smem);
    clk.sync();
    ln_phase<false>(a, a.w.y, lns, lnb, nullptr, nullptr);
  }
  clk.sync();
}

// One 256-thread block an SM (the 64 x 512 ring takes most of its shared
// memory). A 384-thread version with a TMA producer warpgroup was compiled
// at the launch's 168 registers a thread (setmaxnreg only moves registers
// at run time) and spilled 3732 bytes.
__global__ void __launch_bounds__(GEMM_THREADS, 1) resident_kernel(const __grid_constant__ ResidentArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  PhaseClock clk{a.stamps, 0};
  clk.start();
  const int Be = a.Be, lq = a.lq, F = a.F, FF = a.FF, R = Be * lq;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const Workspace& w = a.w;
  const DecoderWeights& p = a.p;

  const long n4 = (long)R * F / 4;  // F is a multiple of 128
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n4; i += (long)gridDim.x * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(a.x_in)[i];
    reinterpret_cast<float4*>(a.x)[i] = v;
    reinterpret_cast<__nv_bfloat162*>(w.xb)[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    reinterpret_cast<__nv_bfloat162*>(w.xb)[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
  clk.sync();

  for (int l = 0; l < a.L; ++l) {
    const float* lns = p.ln_scale + (size_t)l * 3 * F;
    const float* lnb = p.ln_bias + (size_t)l * 3 * F;
    const bf16* vmw = static_cast<const bf16*>(p.vmw) + (size_t)l * R * F;
    const bf16* bco = p.bco + (size_t)l * F;
    const bool fused = sm90_ln_ok(R, F, F);  // as decoder_layers in K1

    // self-attention; where the Hopper GEMM takes self-out, its epilogue
    // also takes the motion rows' cross step and LayerNorm
    bf16_out_phase<EPI_BF16>(GemmArgs{w.xb, F, nullptr, p.wqkv + (size_t)l * F * 3 * F, p.bqkv + (size_t)l * 3 * F,
                                      nullptr, nullptr, w.qkv, R, 3 * F, F, scale, F, nullptr},
                             &a.maps.xb, &a.maps.wqkv, l, smem);
    clk.sync();
    self_attn_phase(a, smem);
    clk.sync();
    if (fused) {
      Sm90Args g{&a.maps.sa, &a.maps.wso, l, p.bso + (size_t)l * F, a.x, a.x, w.xb, lns, lnb, R, F, F, 1.0f, 0};
      g.vmw = vmw;
      g.bco = bco;
      g.ln2_scale = lns + F;
      g.ln2_bias = lnb + F;
      g.aux = a.rows;
      g.lq = lq;
      sm90_phase<EPI_RESID_LN_CROSS>(g, smem);
      clk.sync();
    } else {
      resid_ln_phase(a, clk, &a.maps.sa, &a.maps.wso, l, w.sa, F, p.wso + (size_t)l * F * F, p.bso + (size_t)l * F,
                     F, lns, lnb, smem);
    }

    // identity-band cross-attention: the person rows attend, the motion
    // rows take vmw (above, fused, or in the cross LayerNorm phase)
    wmma_phase<EPI_BF16>(GemmArgs{w.xb, F, a.rows, p.wcq + (size_t)l * F * F, p.bcq + (size_t)l * F, nullptr,
                                  nullptr, w.qp, Be, F, F, scale, F, nullptr},
                         smem);
    clk.sync();
    person_phase(a, p.kmem + (size_t)l * Be * (lq - 1) * F, p.vmem + (size_t)l * Be * (lq - 1) * F, smem);
    clk.sync();
    wmma_phase<EPI_BF16>(GemmArgs{w.pa, F, nullptr, p.wco + (size_t)l * F * F, nullptr, nullptr, nullptr, w.po, Be, F,
                                  F, 1.0f, 0, nullptr},
                         smem);
    clk.sync();
    if (fused)
      person_ln_phase(a, lns + F, lnb + F, vmw, bco);
    else
      ln_phase<true>(a, nullptr, lns + F, lnb + F, vmw, bco);
    clk.sync();

    // FFN
    bf16_out_phase<EPI_GELU>(GemmArgs{w.xb, F, nullptr, p.wf1 + (size_t)l * F * FF, p.bf1 + (size_t)l * FF, nullptr,
                                      nullptr, w.h, R, FF, F, 1.0f, 0, nullptr},
                             &a.maps.xb, &a.maps.wf1, l, smem);
    clk.sync();
    resid_ln_phase(a, clk, &a.maps.h, &a.maps.wf2, l, w.h, FF, p.wf2 + (size_t)l * FF * F, p.bf2 + (size_t)l * F, FF,
                   lns + 2 * F, lnb + 2 * F, smem);
  }
}

}  // namespace

extern "C" size_t msmd_resident_workspace_bytes(int Be, int lq, int F, int FF) {
  size_t total = 0;
  carve(nullptr, Be, lq, F, FF, &total);
  return total;
}

// The grid one step launches (blocks resident at once on the current
// device: one an SM), or a negative CUDA error.
extern "C" int msmd_resident_grid() {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(RES_SMEM));
    if (err != cudaSuccess) return -static_cast<int>(err);
    attr_set = true;
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel, GEMM_THREADS, RES_SMEM);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (!coop || per_sm < 1) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return per_sm * sms;
}

// The compiled kernel's registers a thread, local memory a thread (stack
// frame and spills), static and dynamic shared memory and threads a block:
// out = {numRegs, localSizeBytes, sharedSizeBytes, dynamic, threads}.
// Returns 0 or a CUDA error.
extern "C" int msmd_resident_attributes(long* out) {
  cudaFuncAttributes attr;
  RETURN_IF_ERROR(cudaFuncGetAttributes(&attr, resident_kernel));
  out[0] = attr.numRegs;
  out[1] = static_cast<long>(attr.localSizeBytes);
  out[2] = static_cast<long>(attr.sharedSizeBytes);
  out[3] = static_cast<long>(RES_SMEM);
  out[4] = GEMM_THREADS;
  return 0;
}

// One sampler step's decoder stack, per-entry identity-band mode, as one
// cooperative launch. The arguments are msmd_decoder_forward's, and
// `stamps` null or room for the card's clock at the start and after each
// grid barrier (resident_stamps in ops/kernels/decoder_resident.py).
// Returns the first CUDA error or 0.
extern "C" int msmd_decoder_forward_resident(const void* x_in, void* x_out, void* ws, const void* wqkv,
                                             const void* bqkv, const void* wso, const void* bso, const void* wcq,
                                             const void* bcq, const void* wco, const void* bco, const void* wf1,
                                             const void* bf1, const void* wf2, const void* bf2,
                                             const void* ln_scale, const void* ln_bias, const void* kmem,
                                             const void* vmem, const void* vmw, const void* aux, int Be, int lq,
                                             int F, int H, int L, int FF, void* stamps, void* stream) {
  if (!decoder_shapes_ok(lq, F, H, FF)) return cudaErrorInvalidValue;
  const int grid = msmd_resident_grid();
  if (grid < 0) return -grid;
  size_t total = 0;
  ResidentArgs a{{},
                 static_cast<const float*>(x_in),
                 static_cast<float*>(x_out),
                 carve(ws, Be, lq, F, FF, &total),
                 DecoderWeights{static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
                                static_cast<const bf16*>(wso), static_cast<const bf16*>(bso),
                                static_cast<const bf16*>(wcq), static_cast<const bf16*>(bcq),
                                static_cast<const bf16*>(wco), static_cast<const bf16*>(bco),
                                static_cast<const bf16*>(wf1), static_cast<const bf16*>(bf1),
                                static_cast<const bf16*>(wf2), static_cast<const bf16*>(bf2),
                                static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
                                static_cast<const bf16*>(kmem), static_cast<const bf16*>(vmem), vmw},
                 static_cast<const int*>(aux), Be, lq, F, H, L, FF, static_cast<unsigned long long*>(stamps)};
  if (decoder_uses_sm90(Be * lq, F, FF)) RETURN_IF_ERROR(make_decoder_maps(&a.maps, a.w, a.p, Be * lq, F, FF, L));
  void* args[] = {&a};
  RETURN_IF_ERROR(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(resident_kernel), dim3(grid),
                                              dim3(GEMM_THREADS), args, RES_SMEM, static_cast<cudaStream_t>(stream)));
  return cudaGetLastError();
}
