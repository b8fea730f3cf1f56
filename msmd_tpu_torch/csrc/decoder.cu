// Decoder stack of one MSMD DDPM sampler step, hand-written for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the TPU kernel msmd_tpu/ops/pallas/decoder_kernel.py::
// fused_decoder_forward (body _decoder_kernel -> _layer_compute) in its
// production mode: per-entry self-attention, identity-band cross-attention
// (each entry's person row attends that entry's cached memory K/V; motion
// rows take the hoisted projected V-gather `vmw`), FFN, three post-LNs,
// for all L layers. It computes what _layer_compute computes and rounds
// where it rounds (see ops/kernels/decoder.py); it does not copy the
// Pallas grid. The sub-kernels and the layer loop live in
// decoder_common.cuh, which the batch-1 sampler kernels (sampler.cu)
// share.
//
// What bounds it on an H100: at the batch-48 flagship shapes (Be = 96
// entries of lq = 111 rows, F = 512, FFN 2048, 8 layers) a step is about
// 556 GFLOP of bf16 products (QKV, out-projection and FFN are 94% of it)
// against about 0.36 GB of bytes (weights, memory K/V, vmw, activations):
// ~0.56 ms on the tensor cores at 989 TFLOP/s vs ~0.11 ms at 3.35 TB/s.
// It is compute-bound.
//
// Design: at these shapes the four large products of each layer (QKV,
// self-out, FFN1, FFN2) run on the warp-specialised Hopper GEMM of
// gemm_sm90.cuh (wgmma m64n256k16 from 128-byte-swizzled shared memory,
// 128 x 256 tiles for QKV and FFN1, two-CTA clusters of 128 x 256 tiles
// over the 512 columns of the two residual products, whose epilogue takes
// the post-LayerNorm and writes x and its bf16 copy), so a layer is nine
// launches. Products with fewer than SM90_MIN_ROWS rows (small
// batches; K4 shares this chain) and the person rows' products stay on the
// wmma tile of decoder_common.cuh (bf16 16x16x16, BM x 128 x 32 tiles, a
// 4-deep cp.async ring) with a separate LayerNorm pass. Every epilogue
// fuses the bias, the q scale and bf16 cast, tanh-GELU or the residual
// add. Self-attention runs one block per (entry, head): Q, K, V in
// swizzled shared memory, each warp's 16 x lq scores and bf16 numerators
// in registers (mma.sync), so the 111x111 score matrices never leave the
// SM. The person-row
// cross-attention is one warp per (entry, head). The cross LayerNorm is
// one warp per row and also writes the bf16 copy of x the next product
// reads.
//
// Flat-mask mode (msmd_decoder_forward_flat; _layer_compute with a
// self_mask, decoder_kernel.py:392-400, and at align_mask_width != 1 the
// full masked cross-attention, :459-467): the batch is cut into tiles of
// `tile` whole entries, and every attention of a tile runs over all of
// the tile's rows with an additive f32 mask shared by the tiles (NEG =
// -1e30 where a query may not look): the self-attention (the tile's Rt =
// tile * lq rows against themselves), the full cross-attention (the Rt
// rows against the tile's Mt = tile * lm memory rows) or, at width 1, the
// person rows (tile rows against the Mt memory rows through the person
// mask), whose cross output then takes the per-entry mode's bf16 scatter
// with vmw. A block of the masked attention holds 64 query rows and
// streams the keys 64 at a time; the bf16 softmax has no running max (a
// fixed shift), so numerators and row sums accumulate over the key
// blocks, and a key block whose mask is all at or below MASK_FLOOR =
// -1e29 adds exactly 0 and is skipped. The mode takes one of two routes,
// by its row count R = Be * lq:
// - below SM90_MIN_ROWS (decoder_uses_sm90 false: the 2-slot round at Be =
//   4, batch 1 at Be = 2, up to Be = 8 at lq = 111): one cooperative launch
//   of the persistent small-row stack (decoder_small.cuh), whose phases
//   cut every product, attention and LayerNorm into about as many items as
//   the card holds blocks. At Be = 4 a step is ~25 GFLOP (~0.03 ms) against
//   ~60 MB of weights (~0.02 ms); the chain of ~89 launches on grids of
//   8-112 blocks that ran there took ~2 ms.
// - at SM90_MIN_ROWS and above (Be >= 10 at lq = 111, e.g. batch 48 of a
//   model with align_mask_width != 1): the chain of launches below, whose
//   four large products run on the Hopper GEMM of gemm_sm90.cuh with the
//   LayerNorm in the residual epilogues, as K1 per-entry's do, and whose
//   masked attentions are the small stack's work items, one block each. On
//   an H100 the small stack's 64 x 64 tiles lose there (Be = 10: 1.91 vs
//   1.83 ms; Be = 96: 11.3 vs 6.9 ms a call).

#include "decoder_small.cuh"

namespace {

__global__ void cast_kernel(const float* __restrict__ x_in, float* __restrict__ x, bf16* __restrict__ xb, long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n; i += (long)gridDim.x * blockDim.x) {
    const float v = x_in[i];
    x[i] = v;
    xb[i] = __float2bfloat16(v);
  }
}

DecoderWeights weights(const void* const* w, const void* kmem, const void* vmem, const void* vmw) {
  auto b = [&](int i) { return static_cast<const bf16*>(w[i]); };
  return DecoderWeights{b(0), b(1), b(2), b(3), b(4), b(5), b(6), b(7), b(8), b(9), b(10), b(11),
                        static_cast<const float*>(w[12]), static_cast<const float*>(w[13]),
                        static_cast<const bf16*>(kmem), static_cast<const bf16*>(vmem), vmw};
}

}  // namespace

extern "C" size_t msmd_decoder_workspace_bytes(int Be, int lq, int F, int FF) {
  size_t total = 0;
  carve(nullptr, Be, lq, F, FF, &total);
  return total;
}

// One sampler step's decoder stack. x_in, x_out: (Be*lq, F) f32. Weights
// bf16 in the (L, in, out) layout, biases (L, 1, n) bf16, LN (L, 3, F) f32,
// kmem/vmem (L, Be*(lq-1), F) bf16, vmw (L, Be*lq, F) bf16, aux (Be,) int32
// person rows. Launches on `stream`; returns the first CUDA error or 0.
extern "C" int msmd_decoder_forward(const void* x_in, void* x_out, void* ws, const void* wqkv,
                                    const void* bqkv, const void* wso, const void* bso, const void* wcq,
                                    const void* bcq, const void* wco, const void* bco, const void* wf1,
                                    const void* bf1, const void* wf2, const void* bf2, const void* ln_scale,
                                    const void* ln_bias, const void* kmem, const void* vmem, const void* vmw,
                                    const void* aux, int Be, int lq, int F, int H, int L, int FF, void* stream) {
  if (!decoder_shapes_ok(lq, F, H, FF)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RETURN_IF_ERROR(set_kernel_attributes());
  size_t total = 0;
  Workspace w = carve(ws, Be, lq, F, FF, &total);
  float* x = static_cast<float*>(x_out);
  cast_kernel<<<1024, 256, 0, st>>>(static_cast<const float*>(x_in), x, w.xb, (long)Be * lq * F);
  RETURN_IF_ERROR(cudaGetLastError());
  const void* w14[14] = {wqkv, bqkv, wso, bso, wcq, bcq, wco, bco, wf1, bf1, wf2, bf2, ln_scale, ln_bias};
  return decoder_layers(st, w, x, weights(w14, kmem, vmem, vmw), static_cast<const int*>(aux), Be, lq, F, H, L,
                        FF);
}

namespace {

// Flat-mask mode: the persistent small-row stack of decoder_small.cuh in
// one cooperative launch: x_in copied into x and its bf16 copy, and the
// live 64 x 64 blocks of the masks the masked attentions read, then the L
// layers.
__global__ void __launch_bounds__(SMALL_THREADS, SMALL_MIN_BLOCKS) flat_kernel(const __grid_constant__ SmallArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  PhaseClock clk{a.stamps, 0};
  clk.start();
  const long n = (long)a.Be * a.lq * a.F;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n; i += (long)gridDim.x * blockDim.x) {
    const float v = a.x_in[i];
    a.x[i] = v;
    a.w.xb[i] = __float2bfloat16(v);
  }
  const int Rt = a.tile * a.lq, Mt = a.tile * (a.lq - 1), ns = blocks64(Rt) * blocks64(Rt);
  const int nc = a.w.live_cross ? blocks64(Rt) * blocks64(Mt) : 0;
  for (int i = blockIdx.x; i < ns + nc; i += gridDim.x) {
    if (i < ns)
      mask_live_block(a.self_mask, Rt, Rt, i / blocks64(Rt), i % blocks64(Rt), a.w.live_self);
    else
      mask_live_block(a.cross_mask, Rt, Mt, (i - ns) / blocks64(Mt), (i - ns) % blocks64(Mt), a.w.live_cross);
  }
  clk.sync();
  small_layers(a, clk, smem, true);
}

bool flat_attr_set = false;

int flat_fit() { return small_grid(flat_kernel, &flat_attr_set); }

// whole entries a tile, dividing Be, and a tile's rows within the masked
// attention's list of live key blocks (MAX_LM of 64)
bool flat_tile_ok(int Be, int lq, int tile) { return tile >= 1 && Be % tile == 0 && tile * lq <= MAX_LM * MA_BK; }

SmallPlan flat_plan(int Be, int lq, int F, int FF, int band, int grid) {
  return make_small_plan(band ? SMALL_FLAT_BAND : SMALL_FLAT_FULL, Be, lq, F, FF, grid, 0, 0);
}

// --------------------------------------------------------------------------
// the flat mode's chain of launches, at SM90_MIN_ROWS rows and above
// --------------------------------------------------------------------------

bool flat_chain(int Be, int lq, int F, int FF) { return decoder_uses_sm90(Be * lq, F, FF); }

// decoder_common.cuh's workspace, then the live 64 x 64 blocks of the self
// mask (Rt, Rt) and of the cross mask (Cq, Mt): Cq = Rt for the full cross,
// the tile's person rows for the band
Workspace carve_chain(void* base, int Be, int lq, int F, int FF, int tile, bool band, int** live_self,
                      int** live_cross, size_t* total) {
  const int Rt = tile * lq, Mt = tile * (lq - 1), Cq = band ? tile : Rt;
  Workspace w = carve(base, Be, lq, F, FF, total);
  char* p = static_cast<char*>(base);
  size_t off = align256(*total);
  *live_self = p ? reinterpret_cast<int*>(p + off) : nullptr;
  off += align256((size_t)blocks64(Rt) * blocks64(Rt) * sizeof(int));
  *live_cross = p ? reinterpret_cast<int*>(p + off) : nullptr;
  *total = off + align256((size_t)blocks64(Cq) * blocks64(Mt) * sizeof(int));
  return w;
}

// x_in into x and its bf16 copy, and the live blocks of both masks, one
// 64 x 64 mask block a block (the blocks after those of the two masks cast)
__global__ void __launch_bounds__(SMALL_THREADS) chain_load_kernel(const float* __restrict__ x_in,
                                                                   float* __restrict__ x, bf16* __restrict__ xb,
                                                                   long n, const float* self_mask, int Rt,
                                                                   int* live_self, const float* cross_mask, int Cq,
                                                                   int Mt, int* live_cross) {
  const int ns = blocks64(Rt) * blocks64(Rt), nc = blocks64(Cq) * blocks64(Mt), i = blockIdx.x;
  if (i < ns) {
    mask_live_block(self_mask, Rt, Rt, i / blocks64(Rt), i % blocks64(Rt), live_self);
  } else if (i < ns + nc) {
    mask_live_block(cross_mask, Cq, Mt, (i - ns) / blocks64(Mt), (i - ns) % blocks64(Mt), live_cross);
  } else {
    const long stride = (long)(gridDim.x - ns - nc) * blockDim.x;
    for (long j = (i - ns - nc) * (long)blockDim.x + threadIdx.x; j < n; j += stride) {
      const float v = x_in[j];
      x[j] = v;
      xb[j] = __float2bfloat16(v);
    }
  }
}

// block (query block, head, tile): one work item of the small stack's
// masked attention
__global__ void __launch_bounds__(SMALL_THREADS) chain_masked_kernel(const __grid_constant__ MaskedAttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  masked_attn_item(a, blockIdx.x, blockIdx.y, blockIdx.z, smem);
}

cudaError_t chain_masked(cudaStream_t st, const bf16* q, long ldq, const bf16* k, const bf16* v, long ldkv,
                         const float* mask, const int* live, bf16* out, int rq, int rk, int H, int n_tiles) {
  const MaskedAttnArgs a{q, k, v, ldq, ldkv, ldkv, mask, out, (long)H * DH, rq, rk, nullptr, 0, 0, nullptr, 0.0f,
                         live};
  chain_masked_kernel<<<dim3(blocks64(rq), H, n_tiles), SMALL_THREADS, masked_attn_smem_bytes(), st>>>(a);
  return cudaGetLastError();
}

// All L layers in flat-mask mode on x (Be*lq, F) f32 with its bf16 copy in
// w.xb, as a chain of launches. Width 1 (vmw != null): identity-band cross
// through the person mask (tile, tile*lm) and the hoisted vmw, person rows
// `rows`. Otherwise the full masked cross with cross_mask (tile*lq,
// tile*lm).
cudaError_t decoder_layers_flat(cudaStream_t st, const Workspace& w, float* x, const DecoderWeights& p,
                                const int* rows, const float* self_mask, const float* cross_mask,
                                const int* live_self, const int* live_cross, int Be, int lq, int F, int H, int L,
                                int FF, int tile) {
  const int R = Be * lq, lm = lq - 1, n_tiles = Be / tile, Rt = tile * lq, Mt = tile * lm;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const int ln_blocks = (R * 32 + LN_THREADS - 1) / LN_THREADS;
  const bool band = p.vmw != nullptr;
  DecoderMaps maps;
  RETURN_IF_ERROR(make_decoder_maps(&maps, w, p, R, F, FF, L));
  for (int l = 0; l < L; ++l) {
    const bf16* Wqkv = p.wqkv + (size_t)l * F * 3 * F;
    const bf16* Bqkv = p.bqkv + (size_t)l * 3 * F;
    const bf16* Wso = p.wso + (size_t)l * F * F;
    const bf16* Bso = p.bso + (size_t)l * F;
    const bf16* Wcq = p.wcq + (size_t)l * F * F;
    const bf16* Bcq = p.bcq + (size_t)l * F;
    const bf16* Wco = p.wco + (size_t)l * F * F;
    const bf16* Bco = p.bco + (size_t)l * F;
    const bf16* Wf1 = p.wf1 + (size_t)l * F * FF;
    const bf16* Bf1 = p.bf1 + (size_t)l * FF;
    const bf16* Wf2 = p.wf2 + (size_t)l * FF * F;
    const bf16* Bf2 = p.bf2 + (size_t)l * F;
    const float* lns = p.ln_scale + (size_t)l * 3 * F;
    const float* lnb = p.ln_bias + (size_t)l * 3 * F;
    const bf16* Km = p.kmem + (size_t)l * Be * lm * F;
    const bf16* Vm = p.vmem + (size_t)l * Be * lm * F;

    // self-attention over each tile's flattened rows, masked
    RETURN_IF_ERROR(gemm_bf16_out<EPI_BF16>(st, &maps.xb, &maps.wqkv, l, w.xb, F, Wqkv, Bqkv, w.qkv, R, 3 * F, F,
                                            scale, F));
    RETURN_IF_ERROR(chain_masked(st, w.qkv, 3L * F, w.qkv + F, w.qkv + 2 * F, 3L * F, self_mask, live_self, w.sa,
                                 Rt, Rt, H, n_tiles));
    RETURN_IF_ERROR(gemm_resid_ln(st, &maps.sa, &maps.wso, l, w.sa, F, Wso, Bso, x, w.xb, w.y, lns, lnb, R, F, F));

    if (band) {
      // the person rows attend the tile's memory through the person mask;
      // motion rows take vmw, as in the per-entry mode
      const bf16* Vmw = static_cast<const bf16*>(p.vmw) + (size_t)l * R * F;
      RETURN_IF_ERROR(gemm<EPI_BF16>(st, w.xb, F, rows, Wcq, Bcq, nullptr, w.qp, Be, F, F, scale, F));
      RETURN_IF_ERROR(chain_masked(st, w.qp, F, Km, Vm, F, cross_mask, live_cross, w.pa, tile, Mt, H, n_tiles));
      RETURN_IF_ERROR(gemm<EPI_BF16>(st, w.pa, F, nullptr, Wco, nullptr, nullptr, w.po, Be, F, F));
      ln_kernel<true, bf16><<<ln_blocks, LN_THREADS, 0, st>>>(nullptr, x, w.xb, lns + F, lnb + F, R, F,
                                                              static_cast<const bf16*>(w.po), Vmw, Bco, rows, lq);
    } else {
      // every row attends the tile's memory through the cross mask; q in
      // w.qkv and the attention output in w.sa, both free here
      RETURN_IF_ERROR(gemm_bf16_out<EPI_BF16>(st, &maps.xb, &maps.wcq, l, w.xb, F, Wcq, Bcq, w.qkv, R, F, F, scale,
                                              F));
      RETURN_IF_ERROR(chain_masked(st, w.qkv, F, Km, Vm, F, cross_mask, live_cross, w.sa, Rt, Mt, H, n_tiles));
      RETURN_IF_ERROR(gemm_resid_ln(st, &maps.sa, &maps.wco, l, w.sa, F, Wco, Bco, x, w.xb, w.y, lns + F, lnb + F,
                                    R, F, F));
    }
    RETURN_IF_ERROR(cudaGetLastError());

    RETURN_IF_ERROR(gemm_bf16_out<EPI_GELU>(st, &maps.xb, &maps.wf1, l, w.xb, F, Wf1, Bf1, w.h, R, FF, F));
    RETURN_IF_ERROR(gemm_resid_ln(st, &maps.h, &maps.wf2, l, w.h, FF, Wf2, Bf2, x, w.xb, w.y, lns + 2 * F,
                                  lnb + 2 * F, R, F, FF));
  }
  return cudaSuccess;
}

cudaError_t run_flat_chain(void* ws, float* x, const float* x_in, const DecoderWeights& p, const int* rows,
                           const float* self_mask, const float* cross_mask, int Be, int lq, int F, int H, int L,
                           int FF, int tile, cudaStream_t st) {
  RETURN_IF_ERROR(set_kernel_attributes());
  static bool attr_set = false;
  if (!attr_set) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(chain_masked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(masked_attn_smem_bytes())));
    attr_set = true;
  }
  const bool band = p.vmw != nullptr;
  const int Rt = tile * lq, Mt = tile * (lq - 1), Cq = band ? tile : Rt;
  int *live_self = nullptr, *live_cross = nullptr;
  size_t total = 0;
  Workspace w = carve_chain(ws, Be, lq, F, FF, tile, band, &live_self, &live_cross, &total);
  const int mask_blocks = blocks64(Rt) * blocks64(Rt) + blocks64(Cq) * blocks64(Mt);
  chain_load_kernel<<<mask_blocks + 512, SMALL_THREADS, 0, st>>>(x_in, x, w.xb, (long)Be * lq * F, self_mask, Rt,
                                                                 live_self, cross_mask, Cq, Mt, live_cross);
  RETURN_IF_ERROR(cudaGetLastError());
  return decoder_layers_flat(st, w, x, p, rows, self_mask, cross_mask, live_self, live_cross, Be, lq, F, H, L, FF,
                             tile);
}

}  // namespace

// 1 where the flat mode runs its chain of launches on the Hopper GEMM at
// these shapes, 0 where it runs the persistent small-row stack.
extern "C" int msmd_flat_uses_chain(int Be, int lq, int F, int FF) { return flat_chain(Be, lq, F, FF) ? 1 : 0; }

// Bytes of scratch of one flat-mode call (on the small stack: its plan on
// the current device, `grid_want` blocks, 0: all that fit), or 0 for
// shapes it refuses.
extern "C" size_t msmd_flat_workspace_bytes(int Be, int lq, int F, int H, int FF, int tile, int band,
                                            int grid_want) {
  if (!small_shapes_ok(lq, F, H, FF) || !flat_tile_ok(Be, lq, tile)) return 0;
  size_t total = 0;
  if (flat_chain(Be, lq, F, FF)) {
    int *live_self, *live_cross;
    carve_chain(nullptr, Be, lq, F, FF, tile, band, &live_self, &live_cross, &total);
    return total;
  }
  int grid = 0;
  if (small_launch_grid(flat_fit(), grid_want, &grid) != cudaSuccess) return 0;
  carve_small(nullptr, flat_plan(Be, lq, F, FF, band, grid), Be, lq, F, FF, tile, false, &total);
  return total;
}

// The flat mode's small-stack plan on the current device: out = {grid,
// blocks per SM, dynamic shared memory, phases, then 7 longs a phase
// (small_phases)}, room for 4 + 7 * (1 + 11 L) longs. Returns 0 or a CUDA
// error (also where the shapes take the chain).
extern "C" int msmd_flat_plan(int Be, int lq, int F, int H, int L, int FF, int tile, int band, int grid_want,
                              long* out) {
  if (!small_shapes_ok(lq, F, H, FF) || !flat_tile_ok(Be, lq, tile) || flat_chain(Be, lq, F, FF))
    return cudaErrorInvalidValue;
  int grid = 0;
  const int fit = flat_fit();
  RETURN_IF_ERROR(small_launch_grid(fit, grid_want, &grid));
  int dev = 0, sms = 0;
  RETURN_IF_ERROR(cudaGetDevice(&dev));
  RETURN_IF_ERROR(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  out[0] = grid;
  out[1] = fit / sms;
  out[2] = SMALL_SMEM;
  out[3] = small_phases(flat_plan(Be, lq, F, FF, band, grid), Be, lq, H, L, tile, 0, 0, out + 4);
  return 0;
}

// Flat-mask mode: the arguments of msmd_decoder_forward, the tile (whole
// entries, dividing Be), the (tile*lq, tile*lq) f32 self mask, and either
// (width 1) vmw, the person rows aux and the (tile, tile*lm) person mask
// as cross_mask, or (vmw and aux null) the (tile*lq, tile*lm) cross mask;
// on the small stack `grid_want` blocks (0: all that fit on the card; more
// is refused), and `stamps` null or room for the card's clock at the start
// and after each of the 1 + 11 L phases (the chain takes neither: stamps
// must be null). ws: msmd_flat_workspace_bytes.
extern "C" int msmd_decoder_forward_flat(const void* x_in, void* x_out, void* ws, const void* wqkv,
                                         const void* bqkv, const void* wso, const void* bso, const void* wcq,
                                         const void* bcq, const void* wco, const void* bco, const void* wf1,
                                         const void* bf1, const void* wf2, const void* bf2, const void* ln_scale,
                                         const void* ln_bias, const void* kmem, const void* vmem, const void* vmw,
                                         const void* aux, const void* self_mask, const void* cross_mask, int Be,
                                         int lq, int F, int H, int L, int FF, int tile, int grid_want, void* stamps,
                                         void* stream) {
  if (!small_shapes_ok(lq, F, H, FF) || !flat_tile_ok(Be, lq, tile) || (vmw == nullptr) != (aux == nullptr))
    return cudaErrorInvalidValue;
  const void* w14[14] = {wqkv, bqkv, wso, bso, wcq, bcq, wco, bco, wf1, bf1, wf2, bf2, ln_scale, ln_bias};
  if (flat_chain(Be, lq, F, FF)) {
    if (stamps != nullptr) return cudaErrorInvalidValue;
    return run_flat_chain(ws, static_cast<float*>(x_out), static_cast<const float*>(x_in),
                          weights(w14, kmem, vmem, vmw), static_cast<const int*>(aux),
                          static_cast<const float*>(self_mask), static_cast<const float*>(cross_mask), Be, lq, F, H,
                          L, FF, tile, static_cast<cudaStream_t>(stream));
  }
  int grid = 0;
  RETURN_IF_ERROR(small_launch_grid(flat_fit(), grid_want, &grid));
  const bool band = vmw != nullptr;
  SmallArgs a;
  a.plan = flat_plan(Be, lq, F, FF, band, grid);
  size_t total = 0;
  a.w = carve_small(ws, a.plan, Be, lq, F, FF, tile, false, &total);
  a.x = static_cast<float*>(x_out);
  a.x_in = static_cast<const float*>(x_in);
  a.p = weights(w14, kmem, vmem, vmw);
  a.rows = static_cast<const int*>(aux);
  a.self_mask = static_cast<const float*>(self_mask);
  a.cross_mask = static_cast<const float*>(cross_mask);
  a.cross_f32 = 0;
  a.Be = Be;
  a.lq = lq;
  a.F = F;
  a.H = H;
  a.L = L;
  a.FF = FF;
  a.tile = tile;
  a.stamps = static_cast<unsigned long long*>(stamps);
  RETURN_IF_ERROR(make_small_maps(&a.maps, a.w, a.p, Be * lq, F, FF, L));
  void* args[] = {&a};
  RETURN_IF_ERROR(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(flat_kernel), dim3(grid), dim3(SMALL_THREADS),
                                              args, SMALL_SMEM, static_cast<cudaStream_t>(stream)));
  return cudaGetLastError();
}

// What msmd_gemm's route 0 (the decoder's choice) runs for one product:
// out = {1 for the Hopper GEMM (the warp-specialised pipeline) or 0 for
// the wmma tile, tile rows, tile columns (of one CTA), CTAs per cluster,
// clusters, tiles (of one CTA), grid blocks, dynamic shared-memory bytes};
// all -1 for a shape or epilogue that neither takes (EPI_RESID_LN_CROSS
// has no wmma route).
extern "C" void msmd_gemm_plan(int M, int N, int K, int epi, long* out) {
  for (int i = 0; i < 8; ++i) out[i] = -1;
  const bool cross = epi == EPI_RESID_LN_CROSS, ln = epi == EPI_RESID_LN || cross;
  if (M < 1 || N % BN || K % BK || (!ln && epi != EPI_BF16 && epi != EPI_GELU)) return;
  if (ln ? sm90_ln_ok(M, N, K) : sm90_wide_ok(M, N, K)) {
    const int rb = (M + WS_BM - 1) / WS_BM, grid = ws_grid(ln, M, N, sm_count());
    const int extra = cross ? Sm90Epi<EPI_RESID_LN_CROSS>::EXTRA : ln ? Sm90Epi<EPI_RESID_LN>::EXTRA : 0;
    const long plan[8] = {1, WS_BM, WS_BN, ln ? 2 : 1, ln ? grid / 2 : grid, ln ? 2 * rb : (N / WS_BN) * rb, grid,
                          static_cast<long>(WS_SMEM + extra)};
    for (int i = 0; i < 8; ++i) out[i] = plan[i];
  } else if (!cross) {
    const int bm = N > 512 ? 128 : 64, tiles = (N / BN) * ((M + bm - 1) / bm);
    const long plan[8] = {0, bm, BN, 1, tiles, tiles, tiles,
                          static_cast<long>(N > 512 ? gemm_smem_bytes<128>() : gemm_smem_bytes<64>())};
    for (int i = 0; i < 8; ++i) out[i] = plan[i];
  }
}

namespace {

// One Hopper product of msmd_gemm: the warp-specialised pipeline, or with
// `loop` the tile loop K2 runs (sm90_tiles_loop, the route K1 took before).
template <int EPI>
cudaError_t hopper_product(bool loop, cudaStream_t st, const CUtensorMap& a, const CUtensorMap& b,
                           const Sm90Args& g) {
  return loop ? gemm_sm90_loop<EPI>(st, a, b, g) : gemm_sm90<EPI>(st, a, b, g);
}

}  // namespace

// One product of the decoder alone, for the card tests and the per-product
// timing: route 0 runs what the decoder runs at this shape, 1 the Hopper
// GEMM (refused where the shape does not take it), 2 the wmma tile, 3 the
// Hopper GEMM's tile loop that K2 runs (refused as route 1). A (M, K) and B
// (K, N) bf16 row-major, bias (N) bf16. epi EPI_BF16 (columns < scale_cols
// scaled) or EPI_GELU: C (M, N) bf16. EPI_RESID_LN: C (M, N) f32 x and Cb
// its bf16 copy, LayerNorm(res + A B + bias) with ln_scale, ln_bias (N)
// f32; y is an (M, N) f32 scratch for the wmma route. EPI_RESID_LN_CROSS
// (Hopper routes only): EPI_RESID_LN, then on each row that is not a
// person row (aux[row / lq] == row; aux has a row for every lq rows) the
// cross step with vmw (M, N) bf16 and bco (N) bf16 and the LayerNorm with
// ln2_scale, ln2_bias (N) f32, as K1's self-out product. Launches on
// `stream`; returns the first CUDA error or 0.
extern "C" int msmd_gemm(int route, int epi, const void* A, const void* B, const void* bias, const void* res, void* C,
                         void* Cb, const void* ln_scale, const void* ln_bias, void* y, int M, int N, int K,
                         float scale, int scale_cols, const void* vmw, const void* bco, const void* ln2_scale,
                         const void* ln2_bias, const void* aux, int lq, void* stream) {
  long plan[8];
  msmd_gemm_plan(M, N, K, epi, plan);
  if (plan[0] < 0 || route < 0 || route > 3) return cudaErrorInvalidValue;
  const bool cross = epi == EPI_RESID_LN_CROSS, ln = epi == EPI_RESID_LN || cross, fits = plan[0] == 1;
  if ((route == 1 || route == 3) && !fits) return cudaErrorInvalidValue;
  if (cross && (route == 2 || vmw == nullptr || bco == nullptr || ln2_scale == nullptr || ln2_bias == nullptr ||
                aux == nullptr || lq < 1))
    return cudaErrorInvalidValue;
  const bool hopper = route == 1 || route == 3 || (route == 0 && fits), loop = route == 3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RETURN_IF_ERROR(set_kernel_attributes());
  const bf16 *a = static_cast<const bf16*>(A), *b = static_cast<const bf16*>(B), *bi = static_cast<const bf16*>(bias);
  const float *lns = static_cast<const float*>(ln_scale), *lnb = static_cast<const float*>(ln_bias);
  Sm90Args g{nullptr, nullptr, 0, bi, static_cast<const float*>(res), C, static_cast<bf16*>(Cb), lns, lnb, M, N, K,
             scale, scale_cols};
  if (hopper) {
    CUtensorMap ma, mb;
    RETURN_IF_ERROR(make_a_map(&ma, a, K, M, K, ln ? 64 : 128));
    RETURN_IF_ERROR(make_b_map(&mb, b, K, N, 1));
    if (cross) {
      g.vmw = static_cast<const bf16*>(vmw);
      g.bco = static_cast<const bf16*>(bco);
      g.ln2_scale = static_cast<const float*>(ln2_scale);
      g.ln2_bias = static_cast<const float*>(ln2_bias);
      g.aux = static_cast<const int*>(aux);
      g.lq = lq;
      return hopper_product<EPI_RESID_LN_CROSS>(loop, st, ma, mb, g);
    }
    if (ln) return hopper_product<EPI_RESID_LN>(loop, st, ma, mb, g);
    return epi == EPI_GELU ? hopper_product<EPI_GELU>(loop, st, ma, mb, g)
                           : hopper_product<EPI_BF16>(loop, st, ma, mb, g);
  }
  if (ln) {
    RETURN_IF_ERROR(gemm<EPI_RESID>(st, a, K, nullptr, b, bi, static_cast<const float*>(res), y, M, N, K));
    ln_kernel<false, bf16><<<(M * 32 + LN_THREADS - 1) / LN_THREADS, LN_THREADS, 0, st>>>(
        static_cast<const float*>(y), static_cast<float*>(C), static_cast<bf16*>(Cb), lns, lnb, M, N, nullptr,
        nullptr, nullptr, nullptr, 1);
    return cudaGetLastError();
  }
  return epi == EPI_GELU ? gemm<EPI_GELU>(st, a, K, nullptr, b, bi, nullptr, C, M, N, K)
                         : gemm<EPI_BF16>(st, a, K, nullptr, b, bi, nullptr, C, M, N, K, scale, scale_cols);
}
