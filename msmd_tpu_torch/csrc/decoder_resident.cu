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
// step (cudaLaunchCooperativeKernel) that runs all L layers: the grid is
// exactly as many blocks as fit on the card at once (occupancy x SMs), and
// each phase of a layer hands its work items (GEMM tiles, (entry, head)
// attention blocks, person rows, LayerNorm rows) to the blocks in a
// strided loop, with a grid-wide barrier (cooperative_groups
// this_grid().sync()) between phases:
//
//   QKV GEMM | self-attention | out-proj + residual | LN1 | person-row
//   q GEMM | person attention | wco GEMM of the person rows | LN2 with vmw
//   and bco | FFN1 + GELU | FFN2 + residual | LN3
//
// At the batch-48 flagship shapes (Be = 96 entries of lq = 111 rows,
// F = 512) the f32 activations are 21.8 MB and the bf16 working copies
// another ~50 MB, against the 50 MB L2: x and its bf16 copy stay in L2
// between phases, the FFN hidden state mostly does not. No persisting L2
// access-policy window is set. The work items are K1's own device
// functions (decoder_common.cuh and gemm_sm90.cuh: sm90_tiles_loop, gemm_tile,
// self_attn_block, person_attn_block, ln_row), chosen by the same shape
// rules (sm90_wide_ok, sm90_ln_ok) and summed in the same K order, so K2
// computes the same bits as K1 and differs only in scheduling: 1 launch
// per step instead of 1 + 9 per layer, and no idle tail between
// launches. At Be * lq >= SM90_MIN_ROWS the residual products take their
// LayerNorm in the Hopper GEMM's epilogue, so those phases lose their
// LayerNorm phase and its grid barrier. Dynamic shared memory is the
// largest phase's (the Hopper GEMM's 64 x 512 ring, ~218 KB); the
// registers (255) allow one 256-thread block per SM.
//
// What bounds it: the same ~537 GFLOP of bf16 products per step as K1
// (~0.54 ms at 989 TFLOP/s).

#include <cooperative_groups.h>

#include "decoder_common.cuh"

namespace cg = cooperative_groups;

namespace {

struct ResidentArgs {
  DecoderMaps maps;  // the Hopper products' tensor maps (built where decoder_uses_sm90)
  const float* x_in;
  float* x;
  Workspace w;
  DecoderWeights p;
  const int* rows;  // (Be,) person rows e*lq
  int Be, lq, F, H, L, FF;
};

// Every tile of one product, strided over the persistent blocks. The tile
// height follows gemm() in decoder_common.cuh (128 rows for N > 512).
template <int EPI>
__device__ __forceinline__ void gemm_phase(const GemmArgs& g, unsigned char* smem) {
  const int tn = g.N / BN;
  if (g.N > 512) {
    const int n = tn * ((g.M + 127) / 128);
    for (int i = blockIdx.x; i < n; i += gridDim.x) gemm_tile<EPI, 128>(g, i / tn, i % tn, smem);
  } else {
    const int n = tn * ((g.M + 63) / 64);
    for (int i = blockIdx.x; i < n; i += gridDim.x) gemm_tile<EPI, 64>(g, i / tn, i % tn, smem);
  }
}

// QKV or FFN1 (bf16 out): the Hopper GEMM's tiles (A and B through the
// tensor maps ma, mb in the kernel's parameters, B's layer `layer`) where
// it takes the shape, as gemm_bf16_out chooses in K1, else the wmma tiles.
template <int EPI>
__device__ __forceinline__ void bf16_out_phase(const GemmArgs& g, const CUtensorMap* ma, const CUtensorMap* mb,
                                               int layer, unsigned char* smem) {
  if (sm90_wide_ok(g.M, g.N, g.K))
    sm90_tiles_loop<EPI>(Sm90Args{ma, mb, layer, g.bias, nullptr, g.C, nullptr, nullptr, nullptr, g.M, g.N, g.K,
                                  g.scale, g.scale_cols},
                         smem);
  else
    gemm_phase<EPI>(g, smem);
}

template <bool CROSS>
__device__ __forceinline__ void ln_phase(const ResidentArgs& a, const float* y, const float* scale,
                                         const float* bias, const bf16* vmw, const bf16* bco) {
  const int R = a.Be * a.lq, lane = threadIdx.x % 32;
  const int nw = gridDim.x * (blockDim.x / 32);
  for (int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; row < R; row += nw)
    ln_row<CROSS, bf16>(row, lane, y, a.x, a.w.xb, scale, bias, a.F, static_cast<const bf16*>(a.w.po), vmw,
                        bco, a.rows, a.lq);
}

// x, xb = LayerNorm(x + A @ B + bias) with the grid barriers after it: the
// Hopper GEMM's LayerNorm epilogue where it takes the shape (as
// gemm_resid_ln chooses in K1), else the wmma tiles into y and a
// LayerNorm phase.
__device__ __forceinline__ void resid_ln_phase(const ResidentArgs& a, const CUtensorMap* ma, const CUtensorMap* mb,
                                               int layer, const bf16* A, long lda, const bf16* B, const bf16* bias,
                                               int K, const float* lns, const float* lnb, unsigned char* smem) {
  const int R = a.Be * a.lq, F = a.F;
  if (sm90_ln_ok(R, F, K)) {
    sm90_tiles_loop<EPI_RESID_LN>(Sm90Args{ma, mb, layer, bias, a.x, a.x, a.w.xb, lns, lnb, R, F, K, 1.0f, 0}, smem);
  } else {
    gemm_phase<EPI_RESID>(GemmArgs{A, lda, nullptr, B, bias, nullptr, a.x, a.w.y, R, F, K, 1.0f, 0, nullptr}, smem);
    cg::this_grid().sync();
    ln_phase<false>(a, a.w.y, lns, lnb, nullptr, nullptr);
  }
  cg::this_grid().sync();
}

// No minimum of blocks per SM: asked for two (128 registers), ptxas
// spills (1220 bytes of spill stores, 9004 of loads, a 664-byte stack) and
// the kernel runs slower than with one block of 255 registers per SM.
__global__ void __launch_bounds__(GEMM_THREADS) resident_kernel(const __grid_constant__ ResidentArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int Be = a.Be, lq = a.lq, F = a.F, H = a.H, FF = a.FF, R = Be * lq, lm = lq - 1;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const Workspace& w = a.w;
  const DecoderWeights& p = a.p;

  const long n = (long)R * F;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n; i += (long)gridDim.x * blockDim.x) {
    const float v = a.x_in[i];
    a.x[i] = v;
    w.xb[i] = __float2bfloat16(v);
  }
  grid.sync();

  for (int l = 0; l < a.L; ++l) {
    const float* lns = p.ln_scale + (size_t)l * 3 * F;
    const float* lnb = p.ln_bias + (size_t)l * 3 * F;
    const bf16* Km = p.kmem + (size_t)l * Be * lm * F;
    const bf16* Vm = p.vmem + (size_t)l * Be * lm * F;

    // self-attention
    bf16_out_phase<EPI_BF16>(GemmArgs{w.xb, F, nullptr, p.wqkv + (size_t)l * F * 3 * F, p.bqkv + (size_t)l * 3 * F,
                                      nullptr, nullptr, w.qkv, R, 3 * F, F, scale, F, nullptr},
                             &a.maps.xb, &a.maps.wqkv, l, smem);
    grid.sync();
    for (int i = blockIdx.x; i < Be * H; i += gridDim.x) self_attn_block(w.qkv, w.sa, lq, F, i % H, i / H, smem);
    grid.sync();
    resid_ln_phase(a, &a.maps.sa, &a.maps.wso, l, w.sa, F, p.wso + (size_t)l * F * F, p.bso + (size_t)l * F, F, lns,
                   lnb, smem);

    // identity-band cross-attention: the person rows attend, the motion
    // rows take vmw
    gemm_phase<EPI_BF16>(GemmArgs{w.xb, F, a.rows, p.wcq + (size_t)l * F * F, p.bcq + (size_t)l * F, nullptr,
                                  nullptr, w.qp, Be, F, F, scale, F, nullptr},
                         smem);
    grid.sync();
    for (int e = blockIdx.x; e < Be; e += gridDim.x) {
      __syncthreads();
      person_attn_block(w.qp, Km, Vm, w.pa, lm, F, H, e, reinterpret_cast<float*>(smem));
    }
    grid.sync();
    gemm_phase<EPI_BF16>(GemmArgs{w.pa, F, nullptr, p.wco + (size_t)l * F * F, nullptr, nullptr, nullptr, w.po,
                                  Be, F, F, 1.0f, 0, nullptr},
                         smem);
    grid.sync();
    ln_phase<true>(a, nullptr, lns + F, lnb + F, static_cast<const bf16*>(p.vmw) + (size_t)l * R * F,
                   p.bco + (size_t)l * F);
    grid.sync();

    // FFN
    bf16_out_phase<EPI_GELU>(GemmArgs{w.xb, F, nullptr, p.wf1 + (size_t)l * F * FF, p.bf1 + (size_t)l * FF,
                                      nullptr, nullptr, w.h, R, FF, F, 1.0f, 0, nullptr},
                             &a.maps.xb, &a.maps.wf1, l, smem);
    grid.sync();
    resid_ln_phase(a, &a.maps.h, &a.maps.wf2, l, w.h, FF, p.wf2 + (size_t)l * FF * F, p.bf2 + (size_t)l * F, FF,
                   lns + 2 * F, lnb + 2 * F, smem);
  }
}

size_t resident_smem_bytes(int lq, int H) {
  size_t b = Sm90Tile<1>::SMEM > Sm90Tile<2>::SMEM ? Sm90Tile<1>::SMEM : Sm90Tile<2>::SMEM;
  if (gemm_smem_bytes<128>() > b) b = gemm_smem_bytes<128>();
  if (gemm_smem_bytes<64>() > b) b = gemm_smem_bytes<64>();
  if (att_smem_bytes(lq) > b) b = att_smem_bytes(lq);
  const size_t person = (size_t)(GEMM_THREADS / 32) * (DH + MAX_LM) * sizeof(float);
  return person > b ? person : b;
}

}  // namespace

extern "C" size_t msmd_resident_workspace_bytes(int Be, int lq, int F, int FF) {
  size_t total = 0;
  carve(nullptr, Be, lq, F, FF, &total);
  return total;
}

// The grid one step launches (blocks resident at once on the current
// device at this lq's shared memory), or a negative CUDA error.
extern "C" int msmd_resident_grid(int lq, int H) {
  static bool attr_set = false;
  if (!attr_set) {
    const size_t most = resident_smem_bytes(MAX_LM, H);
    cudaError_t err = cudaFuncSetAttribute(resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(most));
    if (err != cudaSuccess) return -static_cast<int>(err);
    attr_set = true;
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel, GEMM_THREADS,
                                                        resident_smem_bytes(lq, H));
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (!coop || per_sm < 1) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return per_sm * sms;
}

// One sampler step's decoder stack, per-entry identity-band mode, as one
// cooperative launch. The arguments are msmd_decoder_forward's. Returns
// the first CUDA error or 0.
extern "C" int msmd_decoder_forward_resident(const void* x_in, void* x_out, void* ws, const void* wqkv,
                                             const void* bqkv, const void* wso, const void* bso, const void* wcq,
                                             const void* bcq, const void* wco, const void* bco, const void* wf1,
                                             const void* bf1, const void* wf2, const void* bf2,
                                             const void* ln_scale, const void* ln_bias, const void* kmem,
                                             const void* vmem, const void* vmw, const void* aux, int Be, int lq,
                                             int F, int H, int L, int FF, void* stream) {
  if (!decoder_shapes_ok(lq, F, H, FF)) return cudaErrorInvalidValue;
  const int grid = msmd_resident_grid(lq, H);
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
                 static_cast<const int*>(aux), Be, lq, F, H, L, FF};
  if (decoder_uses_sm90(Be * lq, F, FF)) RETURN_IF_ERROR(make_decoder_maps(&a.maps, a.w, a.p, Be * lq, F, FF, L));
  void* args[] = {&a};
  RETURN_IF_ERROR(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(resident_kernel), dim3(grid),
                                              dim3(GEMM_THREADS), args, resident_smem_bytes(lq, H),
                                              static_cast<cudaStream_t>(stream)));
  return cudaGetLastError();
}
