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
// Design, simple first: the products run on the tensor cores through
// one tiled GEMM (wmma bf16 16x16x16 with f32 accumulation, BM x 128 x 32
// block tiles with BM = 128 for the wide products and 64 for the N = 512
// ones, a 4-deep cp.async ring) whose epilogue fuses the bias, the q scale
// and bf16 cast, tanh-GELU, or the residual add. Attention runs one block
// per (entry, head) with Q, K, V, the f32 scores and the bf16 numerators
// all in shared memory, so the 111x111 score matrices never reach device
// memory. The person-row cross-attention is one warp per (entry, head).
// LayerNorm is one warp per row and also writes the bf16 copy of x the
// next product reads. Not yet used: wgmma, TMA, persistent blocks, fusing
// the LayerNorms into the GEMM epilogues; the GEMM's 128-wide tiles read
// 43 to 64 FLOP per byte from L2, which caps it well below the tensor
// cores' rate.

#include "decoder_common.cuh"

namespace {

__global__ void cast_kernel(const float* __restrict__ x_in, float* __restrict__ x, bf16* __restrict__ xb, long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n; i += (long)gridDim.x * blockDim.x) {
    const float v = x_in[i];
    x[i] = v;
    xb[i] = __float2bfloat16(v);
  }
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
  const DecoderWeights p{static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
                         static_cast<const bf16*>(wso),  static_cast<const bf16*>(bso),
                         static_cast<const bf16*>(wcq),  static_cast<const bf16*>(bcq),
                         static_cast<const bf16*>(wco),  static_cast<const bf16*>(bco),
                         static_cast<const bf16*>(wf1),  static_cast<const bf16*>(bf1),
                         static_cast<const bf16*>(wf2),  static_cast<const bf16*>(bf2),
                         static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
                         static_cast<const bf16*>(kmem), static_cast<const bf16*>(vmem), vmw};
  return decoder_layers(st, w, x, p, static_cast<const int*>(aux), Be, lq, F, H, L, FF, CROSS_BF16);
}
