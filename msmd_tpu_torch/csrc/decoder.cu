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
// self-out, FFN1, FFN2) run on the Hopper GEMM of gemm_sm90.cuh (wgmma
// m64n256k16 from 128-byte-swizzled shared memory, 128 x 256 tiles for QKV
// and FFN1, 64 x 512 tiles for the two residual products, whose epilogue
// takes the post-LayerNorm and writes x and its bf16 copy), so a layer is
// nine launches. Products with fewer than SM90_MIN_ROWS rows (K3, K4, the
// flat-mask mode, small batches) and the person rows' products stay on the
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
// -1e30 where a query may not look). The GEMMs and LayerNorms are the
// per-entry mode's. What is new is one masked attention kernel for the
// self-attention (the tile's Rt = tile * lq rows against themselves, an
// (Rt, Rt) mask), for the full cross-attention (the Rt rows against the
// tile's Mt = tile * lm memory rows, an (Rt, Mt) mask), and, at width 1,
// for the person rows (tile rows against the Mt memory rows, the (tile,
// Mt) person mask), whose cross output then takes the per-entry mode's
// bf16 scatter with vmw. At Be = 4, lq = 111 a head's scores are 444 x
// 444 f32 (0.79 MB), beyond shared memory, so a block holds 64 query rows
// and streams the keys through shared memory 64 at a time. The bf16
// softmax has no running max (exp(clamp(s - 20, -80, 60)), a fixed
// shift), so numerators and row sums simply accumulate over the key
// blocks; a key block whose mask is all at or below _MASK_FLOOR = -1e29
// adds exactly 0 and is skipped, which leaves ~1 / tile of the
// block-diagonal self mask's blocks to compute. Bound: at Be = 4 a step
// is ~25 GFLOP (~0.03 ms) against ~60 MB of weights (~0.02 ms); the ~11
// launches per layer on grids of 8-112 blocks make it latency-bound.

#include "decoder_common.cuh"

namespace {

__global__ void cast_kernel(const float* __restrict__ x_in, float* __restrict__ x, bf16* __restrict__ xb, long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n; i += (long)gridDim.x * blockDim.x) {
    const float v = x_in[i];
    x[i] = v;
    xb[i] = __float2bfloat16(v);
  }
}

// --------------------------------------------------------------------------
// masked attention over a tile: block (query block, head, tile)
// --------------------------------------------------------------------------

constexpr float MASK_FLOOR = -1e29f;  // scores at or below are structural masks
constexpr int MA_BQ = 64, MA_BK = 64, MA_THREADS = 256;
constexpr int MA_LD = DH + 8;      // bf16 row stride of Q, K, V, P
constexpr int MA_SLD = MA_BK + 4;  // f32 row stride of the scores, the mask tile and the output

constexpr size_t masked_attn_smem_bytes() {
  return (size_t)4 * MA_BQ * MA_LD * sizeof(bf16) + (size_t)2 * MA_BQ * MA_SLD * sizeof(float) +
         MA_BQ * sizeof(float);
}

struct MaskedAttnArgs {
  const bf16 *q, *k, *v;  // row r of head h at base + r * ld + h * DH
  long ldq, ldk, ldv;
  const float* mask;  // (rq, rk) additive f32, the same for every tile
  bf16* out;          // row r of head h at out + r * ldo + h * DH
  long ldo;
  int rq, rk;  // query rows and key rows per tile
};

// out = (exp(clamp_unmasked(q k^T + mask - 20)) v) / rowsum, with q already
// scaled and every product on bf16 operands with f32 accumulation. Tile
// t's query rows are t * rq .. and its key rows t * rk ..
__global__ void __launch_bounds__(MA_THREADS) masked_attn_kernel(MaskedAttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + MA_BQ * MA_LD;
  bf16* Vs = Ks + MA_BK * MA_LD;
  bf16* Ps = Vs + MA_BK * MA_LD;
  float* Ss = reinterpret_cast<float*>(Ps + MA_BQ * MA_LD);  // scores, then the output
  float* Ms = Ss + MA_BQ * MA_SLD;                            // the mask tile
  float* rs = Ms + MA_BQ * MA_SLD;                            // row sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * MA_BQ, h = blockIdx.y, t = blockIdx.z;
  const long qrow0 = (long)t * a.rq + q0, krow0 = (long)t * a.rk;

  for (int i = tid; i < MA_BQ * (DH / 8); i += MA_THREADS) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    uint4 q = make_uint4(0, 0, 0, 0);
    if (q0 + r < a.rq) q = *reinterpret_cast<const uint4*>(a.q + (qrow0 + r) * a.ldq + h * DH + c);
    *reinterpret_cast<uint4*>(Qs + r * MA_LD + c) = q;
  }
  if (tid < MA_BQ) rs[tid] = 0.0f;

  // each warp owns one 16-row strip of the output and two of its four
  // 16-column fragments, summed over the key blocks in registers
  const int oi = warp / 2, oj = (warp % 2) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  for (int kb = 0; kb < a.rk; kb += MA_BK) {
    __syncthreads();  // the previous key block is done with Ks, Vs, Ps, Ms
    int live = 0;
    for (int i = tid; i < MA_BQ * MA_BK; i += MA_THREADS) {
      const int r = i / MA_BK, c = i % MA_BK;
      float m = -1e30f;  // rows and keys past the edge get no weight
      if (q0 + r < a.rq && kb + c < a.rk) {
        m = a.mask[(long)(q0 + r) * a.rk + kb + c];
        live |= m > MASK_FLOOR;
      }
      Ms[r * MA_SLD + c] = m;
    }
    if (!__syncthreads_or(live)) continue;  // every score of this block is masked: it adds exactly 0

    for (int i = tid; i < MA_BK * (DH / 8); i += MA_THREADS) {
      const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
      uint4 k = make_uint4(0, 0, 0, 0), v = k;
      if (kb + r < a.rk) {
        k = *reinterpret_cast<const uint4*>(a.k + (krow0 + kb + r) * a.ldk + h * DH + c);
        v = *reinterpret_cast<const uint4*>(a.v + (krow0 + kb + r) * a.ldv + h * DH + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * MA_LD + c) = k;
      *reinterpret_cast<uint4*>(Vs + r * MA_LD + c) = v;
    }
    __syncthreads();

    // S = Q K^T (f32): 4 x 4 fragments, two per warp
    for (int f = warp; f < (MA_BQ / 16) * (MA_BK / 16); f += MA_THREADS / 32) {
      const int ti = f / (MA_BK / 16), tj = f % (MA_BK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
#pragma unroll
      for (int k = 0; k < DH; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + ti * 16 * MA_LD + k, MA_LD);
        wmma::load_matrix_sync(fb, Ks + tj * 16 * MA_LD + k, MA_LD);
        wmma::mma_sync(s, fa, fb, s);
      }
      wmma::store_matrix_sync(Ss + ti * 16 * MA_SLD + tj * 16, s, MA_SLD, wmma::mem_row_major);
    }
    __syncthreads();

    // numerators: the mask is added before the floor test, the -20 shift
    // after it (-1e30 - 20 == -1e30 in f32); a masked score's exp is 0
    for (int r = warp * (MA_BQ / 8); r < (warp + 1) * (MA_BQ / 8); ++r) {
      float sum = 0.0f;
      for (int c = lane; c < MA_BK; c += 32) {
        const float sh = (Ss[r * MA_SLD + c] + Ms[r * MA_SLD + c]) - 20.0f;
        const float p = sh > MASK_FLOOR ? expf(fminf(fmaxf(sh, -80.0f), 60.0f)) : 0.0f;
        sum += p;
        Ps[r * MA_LD + c] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) rs[r] += sum;
    }
    __syncthreads();

    // O += P V
#pragma unroll
    for (int k = 0; k < MA_BK; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, Ps + oi * 16 * MA_LD + k, MA_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Vs + k * MA_LD + (oj + j) * 16, MA_LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Ss + oi * 16 * MA_SLD + (oj + j) * 16, acc[j], MA_SLD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < MA_BQ * DH; i += MA_THREADS) {
    const int r = i / DH, c = i % DH;
    if (q0 + r < a.rq) {
      const float inv = 1.0f / rs[r];
      a.out[(qrow0 + r) * a.ldo + h * DH + c] = __float2bfloat16(Ss[r * MA_SLD + c] * inv);
    }
  }
}

cudaError_t masked_attn(cudaStream_t st, const MaskedAttnArgs& a, int H, int n_tiles) {
  masked_attn_kernel<<<dim3((a.rq + MA_BQ - 1) / MA_BQ, H, n_tiles), MA_THREADS, masked_attn_smem_bytes(), st>>>(a);
  return cudaGetLastError();
}

// All L layers in flat-mask mode on x (Be*lq, F) f32 with its bf16 copy in
// w.xb. Width 1 (vmw != null): identity-band cross through the person mask
// (tile, tile*lm) and the hoisted vmw, person rows `rows`. Otherwise the
// full masked cross with cross_mask (tile*lq, tile*lm).
cudaError_t decoder_layers_flat(cudaStream_t st, const Workspace& w, float* x, const DecoderWeights& p,
                                const int* rows, const float* self_mask, const float* cross_mask, int Be, int lq,
                                int F, int H, int L, int FF, int tile) {
  const int R = Be * lq, lm = lq - 1, n_tiles = Be / tile, Rt = tile * lq, Mt = tile * lm;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const int ln_blocks = (R * 32 + LN_THREADS - 1) / LN_THREADS;
  const bool band = p.vmw != nullptr;
  DecoderMaps maps;
  const bool hopper = decoder_uses_sm90(R, F, FF);
  if (hopper) RETURN_IF_ERROR(make_decoder_maps(&maps, w, p, R, F, FF, L));
  auto map = [&](const CUtensorMap& m) { return hopper ? &m : nullptr; };
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
    RETURN_IF_ERROR(gemm_bf16_out<EPI_BF16>(st, map(maps.xb), map(maps.wqkv), l, w.xb, F, Wqkv, Bqkv, w.qkv, R,
                                            3 * F, F, scale, F));
    RETURN_IF_ERROR(masked_attn(st, MaskedAttnArgs{w.qkv, w.qkv + F, w.qkv + 2 * F, 3L * F, 3L * F, 3L * F,
                                                   self_mask, w.sa, F, Rt, Rt}, H, n_tiles));
    RETURN_IF_ERROR(gemm_resid_ln(st, map(maps.sa), map(maps.wso), l, w.sa, F, Wso, Bso, x, w.xb, w.y, lns, lnb, R,
                                  F, F));

    if (band) {
      // the person rows attend the tile's memory through the person mask;
      // motion rows take vmw, as in the per-entry mode
      const bf16* Vmw = static_cast<const bf16*>(p.vmw) + (size_t)l * R * F;
      RETURN_IF_ERROR(gemm<EPI_BF16>(st, w.xb, F, rows, Wcq, Bcq, nullptr, w.qp, Be, F, F, scale, F));
      RETURN_IF_ERROR(masked_attn(st, MaskedAttnArgs{w.qp, Km, Vm, F, F, F, cross_mask, w.pa, F, tile, Mt},
                                  H, n_tiles));
      RETURN_IF_ERROR(gemm<EPI_BF16>(st, w.pa, F, nullptr, Wco, nullptr, nullptr, w.po, Be, F, F));
      ln_kernel<true, bf16><<<ln_blocks, LN_THREADS, 0, st>>>(nullptr, x, w.xb, lns + F, lnb + F, R, F,
                                                              static_cast<const bf16*>(w.po), Vmw, Bco, rows, lq);
    } else {
      // every row attends the tile's memory through the cross mask; q in
      // w.qkv and the attention output in w.sa, both free here
      RETURN_IF_ERROR(gemm_bf16_out<EPI_BF16>(st, map(maps.xb), map(maps.wcq), l, w.xb, F, Wcq, Bcq, w.qkv, R, F, F,
                                              scale, F));
      RETURN_IF_ERROR(masked_attn(st, MaskedAttnArgs{w.qkv, Km, Vm, F, F, F, cross_mask, w.sa, F, Rt, Mt},
                                  H, n_tiles));
      RETURN_IF_ERROR(gemm_resid_ln(st, map(maps.sa), map(maps.wco), l, w.sa, F, Wco, Bco, x, w.xb, w.y, lns + F,
                                    lnb + F, R, F, F));
    }
    RETURN_IF_ERROR(cudaGetLastError());

    RETURN_IF_ERROR(gemm_bf16_out<EPI_GELU>(st, map(maps.xb), map(maps.wf1), l, w.xb, F, Wf1, Bf1, w.h, R, FF, F));
    RETURN_IF_ERROR(gemm_resid_ln(st, map(maps.h), map(maps.wf2), l, w.h, FF, Wf2, Bf2, x, w.xb, w.y, lns + 2 * F,
                                  lnb + 2 * F, R, F, FF));
  }
  return cudaSuccess;
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
                        FF, CROSS_BF16);
}

// Flat-mask mode: the arguments of msmd_decoder_forward, the tile (whole
// entries, dividing Be), the (tile*lq, tile*lq) f32 self mask, and either
// (width 1) vmw, the person rows aux and the (tile, tile*lm) person mask
// as cross_mask, or (vmw and aux null) the (tile*lq, tile*lm) cross mask.
extern "C" int msmd_decoder_forward_flat(const void* x_in, void* x_out, void* ws, const void* wqkv,
                                         const void* bqkv, const void* wso, const void* bso, const void* wcq,
                                         const void* bcq, const void* wco, const void* bco, const void* wf1,
                                         const void* bf1, const void* wf2, const void* bf2, const void* ln_scale,
                                         const void* ln_bias, const void* kmem, const void* vmem, const void* vmw,
                                         const void* aux, const void* self_mask, const void* cross_mask, int Be,
                                         int lq, int F, int H, int L, int FF, int tile, void* stream) {
  if (!decoder_shapes_ok(lq, F, H, FF) || tile < 1 || Be % tile || (vmw == nullptr) != (aux == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RETURN_IF_ERROR(set_kernel_attributes());
  static bool attr_set = false;
  if (!attr_set) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(masked_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(masked_attn_smem_bytes())));
    attr_set = true;
  }
  size_t total = 0;
  Workspace w = carve(ws, Be, lq, F, FF, &total);
  float* x = static_cast<float*>(x_out);
  cast_kernel<<<1024, 256, 0, st>>>(static_cast<const float*>(x_in), x, w.xb, (long)Be * lq * F);
  RETURN_IF_ERROR(cudaGetLastError());
  const void* w14[14] = {wqkv, bqkv, wso, bso, wcq, bcq, wco, bco, wf1, bf1, wf2, bf2, ln_scale, ln_bias};
  return decoder_layers_flat(st, w, x, weights(w14, kmem, vmem, vmw), static_cast<const int*>(aux),
                             static_cast<const float*>(self_mask), static_cast<const float*>(cross_mask), Be, lq,
                             F, H, L, FF, tile);
}


// What msmd_gemm's route 0 (the decoder's choice) runs for one product:
// out = {1 for the Hopper GEMM or 0 for the wmma tile, tile rows, tile
// columns, tiles, grid blocks, dynamic shared-memory bytes}; all -1 for a
// shape or epilogue that neither takes.
extern "C" void msmd_gemm_plan(int M, int N, int K, int epi, long* out) {
  for (int i = 0; i < 6; ++i) out[i] = -1;
  const bool ln = epi == EPI_RESID_LN;
  if (M < 1 || N % BN || K % BK || (!ln && epi != EPI_BF16 && epi != EPI_GELU)) return;
  if (ln ? sm90_ln_ok(M, N, K) : sm90_wide_ok(M, N, K)) {
    const int wgm = ln ? 1 : 2, tiles = sm90_tiles(M, N, wgm), sms = sm_count();
    const long smem = ln ? Sm90Tile<1>::SMEM : Sm90Tile<2>::SMEM;
    const long plan[6] = {1, 64 * wgm, 256 * (2 / wgm), tiles, tiles < sms ? tiles : sms, smem};
    for (int i = 0; i < 6; ++i) out[i] = plan[i];
  } else {
    const int bm = N > 512 ? 128 : 64, tiles = (N / BN) * ((M + bm - 1) / bm);
    const long plan[6] = {0, bm, BN, tiles, tiles,
                          static_cast<long>(N > 512 ? gemm_smem_bytes<128>() : gemm_smem_bytes<64>())};
    for (int i = 0; i < 6; ++i) out[i] = plan[i];
  }
}

// One product of the decoder alone, for the card tests and the per-product
// timing: route 0 runs what the decoder runs at this shape, 1 the Hopper
// GEMM (refused where the shape does not take it), 2 the wmma tile. A (M,
// K) and B (K, N) bf16 row-major, bias (N) bf16. epi EPI_BF16 (columns <
// scale_cols scaled) or EPI_GELU: C (M, N) bf16. EPI_RESID_LN: C (M, N)
// f32 x and Cb its bf16 copy, LayerNorm(res + A B + bias) with ln_scale,
// ln_bias (N) f32; y is an (M, N) f32 scratch for the wmma route. Launches
// on `stream`; returns the first CUDA error or 0.
extern "C" int msmd_gemm(int route, int epi, const void* A, const void* B, const void* bias, const void* res, void* C,
                         void* Cb, const void* ln_scale, const void* ln_bias, void* y, int M, int N, int K,
                         float scale, int scale_cols, void* stream) {
  long plan[6];
  msmd_gemm_plan(M, N, K, epi, plan);
  if (plan[0] < 0 || route < 0 || route > 2) return cudaErrorInvalidValue;
  const bool ln = epi == EPI_RESID_LN;
  const bool fits = ln ? sm90_ln_ok(M, N, K) : sm90_wide_ok(M, N, K);
  if (route == 1 && !fits) return cudaErrorInvalidValue;
  const bool hopper = route == 1 || (route == 0 && fits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RETURN_IF_ERROR(set_kernel_attributes());
  const bf16 *a = static_cast<const bf16*>(A), *b = static_cast<const bf16*>(B), *bi = static_cast<const bf16*>(bias);
  const float *lns = static_cast<const float*>(ln_scale), *lnb = static_cast<const float*>(ln_bias);
  CUtensorMap ma, mb;
  if (hopper) {
    RETURN_IF_ERROR(make_a_map(&ma, a, K, M, K, ln ? 64 : 128));
    RETURN_IF_ERROR(make_b_map(&mb, b, K, N, 1));
  }
  if (ln) {
    if (hopper)
      return gemm_sm90<EPI_RESID_LN>(st, ma, mb, Sm90Args{nullptr, nullptr, 0, bi, static_cast<const float*>(res), C,
                                                          static_cast<bf16*>(Cb), lns, lnb, M, N, K, 1.0f, 0});
    RETURN_IF_ERROR(gemm<EPI_RESID>(st, a, K, nullptr, b, bi, static_cast<const float*>(res), y, M, N, K));
    ln_kernel<false, bf16><<<(M * 32 + LN_THREADS - 1) / LN_THREADS, LN_THREADS, 0, st>>>(
        static_cast<const float*>(y), static_cast<float*>(C), static_cast<bf16*>(Cb), lns, lnb, M, N, nullptr,
        nullptr, nullptr, nullptr, 1);
    return cudaGetLastError();
  }
  const Sm90Args g{nullptr, nullptr, 0, bi, nullptr, C, nullptr, nullptr, nullptr, M, N, K, scale, scale_cols};
  if (hopper) return epi == EPI_GELU ? gemm_sm90<EPI_GELU>(st, ma, mb, g) : gemm_sm90<EPI_BF16>(st, ma, mb, g);
  return epi == EPI_GELU ? gemm<EPI_GELU>(st, a, K, nullptr, b, bi, nullptr, C, M, N, K)
                         : gemm<EPI_BF16>(st, a, K, nullptr, b, bi, nullptr, C, M, N, K, scale, scale_cols);
}
