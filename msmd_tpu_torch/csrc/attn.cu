// K8: the per-entry, unmasked self-attention middle softmax(q k^T / sqrt(dh)) v
// from projected q, k, v, hand-written for Hopper (sm_90a) and bound to
// PyTorch through a plain C interface.
//
// Replaces msmd_tpu/ops/pallas/attn_kernel.py::attention_middle
// (_attn_mid_kernel), the opt-in (MSMD_ATTN_KERNEL=1) self-attention of
// the XLA-decoder route. Rounding follows _attn_mid_kernel, which is not
// the decoder kernel's "fast" softmax: q is scaled by 1/sqrt(dh) in f32 and
// then cast to bf16; the scores are f32; the softmax is exact and
// max-subtracting (jax.nn.softmax), normalised before the PV product, with
// P cast to bf16; the PV sums are f32; the output is bf16.
//
// One block per (head, entry): q, k and v of that entry and head are
// staged in shared memory (rows zero-padded to a multiple of 16), the
// lq x lq f32 scores stay there (111 x 111 at the flagship: 52 KB with
// the row pad), and the products run on the tensor cores (wmma bf16
// 16x16x16, f32 accumulation). q, k and v may be column slices of one
// (rows, 3F) projection: each row r of entry e starts at
// base + (e * lq + r) * ld.
//
// Bound on an H100 SXM at the guided batch-48 shapes (B 96, lq 111, F 512,
// 8 heads of 64): 2.4 GFLOP against 4 x 10.9 MB of q, k, v in and out:
// bound by bytes (13 us at 3.35 TB/s).

#include "decoder_common.cuh"

namespace {

constexpr int P_LD_MAX = 2 * QK_LD;  // P (bf16) fits over Q and K when lp + 8 <= this

__host__ __device__ inline int mid_s_ld(int lp) { return lp + 4 > O_LD ? lp + 4 : O_LD; }

// Q, K, V (bf16), the f32 scores (later the PV output), then P (bf16) where
// it does not fit over Q and K.
inline size_t mid_smem_bytes(int lq) {
  const int lp = att_lp(lq);
  size_t b = (size_t)3 * lp * QK_LD * 2 + (size_t)lp * mid_s_ld(lp) * 4;
  if (lp + 8 > P_LD_MAX) b += (size_t)lp * (lp + 8) * 2;
  return b;
}

__global__ void __launch_bounds__(ATT_THREADS) attn_mid_kernel(const bf16* __restrict__ q,
                                                               const bf16* __restrict__ k,
                                                               const bf16* __restrict__ v, long ld,
                                                               bf16* __restrict__ out, int lq, int F,
                                                               float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, e = blockIdx.y;
  const int nt = (lq + 15) / 16, lp = nt * 16;
  const int s_ld = mid_s_ld(lp), p_ld = lp + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + lp * QK_LD;
  bf16* Vs = Ks + lp * QK_LD;
  float* Ss = reinterpret_cast<float*>(Vs + lp * QK_LD);  // scores, then the PV output
  bf16* Ps = p_ld <= P_LD_MAX ? Qs : reinterpret_cast<bf16*>(Ss + lp * s_ld);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long row0 = (long)e * lq;

  for (int i = tid; i < lp * (DH / 8); i += ATT_THREADS) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0), kv = qv, vv = qv;
    if (r < lq) {
      const long off = (row0 + r) * ld + h * DH + c;
      qv = *reinterpret_cast<const uint4*>(q + off);
      kv = *reinterpret_cast<const uint4*>(k + off);
      vv = *reinterpret_cast<const uint4*>(v + off);
      bf16* q8 = reinterpret_cast<bf16*>(&qv);
#pragma unroll
      for (int t = 0; t < 8; ++t) q8[t] = __float2bfloat16(__bfloat162float(q8[t]) * scale);
    }
    *reinterpret_cast<uint4*>(Qs + r * QK_LD + c) = qv;
    *reinterpret_cast<uint4*>(Ks + r * QK_LD + c) = kv;
    *reinterpret_cast<uint4*>(Vs + r * QK_LD + c) = vv;
  }
  __syncthreads();

  // S = Q K^T (f32)
  for (int t = warp; t < nt * nt; t += ATT_THREADS / 32) {
    const int ti = t / nt, tj = t % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Qs + ti * 16 * QK_LD + kk, QK_LD);
      wmma::load_matrix_sync(b, Ks + tj * 16 * QK_LD + kk, QK_LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Ss + ti * 16 * s_ld + tj * 16, acc, s_ld, wmma::mem_row_major);
  }
  __syncthreads();

  // P = softmax(S) over the lq real keys, exact and max-subtracting,
  // normalised in f32, then cast to bf16; pad rows and columns are 0
  for (int r = warp; r < lp; r += ATT_THREADS / 32) {
    float m = -INFINITY;
    if (r < lq)
      for (int c = lane; c < lq; c += 32) m = fmaxf(m, Ss[r * s_ld + c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    if (r < lq)
      for (int c = lane; c < lq; c += 32) sum += expf(Ss[r * s_ld + c] - m);
    sum = warp_sum(sum);
    __syncwarp();
    for (int c = lane; c < lp; c += 32) {
      const float p = (r < lq && c < lq) ? expf(Ss[r * s_ld + c] - m) / sum : 0.0f;
      Ps[r * p_ld + c] = __float2bfloat16(p);
    }
  }
  __syncthreads();

  // O = P V (f32), written over the scores
  for (int t = warp; t < nt * (DH / 16); t += ATT_THREADS / 32) {
    const int ti = t / (DH / 16), tj = t % (DH / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < lp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, Ps + ti * 16 * p_ld + kk, p_ld);
      wmma::load_matrix_sync(b, Vs + kk * QK_LD + tj * 16, QK_LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Ss + ti * 16 * O_LD + tj * 16, acc, O_LD, wmma::mem_row_major);
  }
  __syncthreads();

  for (int i = tid; i < lq * DH; i += ATT_THREADS) {
    const int r = i / DH, c = i % DH;
    out[(row0 + r) * F + h * DH + c] = __float2bfloat16(Ss[r * O_LD + c]);
  }
}

}  // namespace

// The shared memory one block takes at lq; the wrapper refuses an lq whose
// block would not fit in the card's limit.
extern "C" size_t msmd_attn_smem_bytes(int lq) { return mid_smem_bytes(lq); }

// out (B*lq, F) bf16 = per entry and head softmax(q k^T / sqrt(64)) v, with
// q, k, v bf16 rows of stride ld (elements) and head dim 64. Launches on
// `stream`; returns the first CUDA error or 0.
extern "C" int msmd_attn_forward(const bf16* q, const bf16* k, const bf16* v, long ld, bf16* out, int B, int lq,
                                 int F, int H, cudaStream_t st) {
  if (B <= 0 || lq <= 0 || F != H * DH || ld < F || ld % 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mid_smem_bytes(lq);
  static size_t smem_set = 0;  // the limit is raised only when a longer lq needs more
  if (smem > smem_set) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(attn_mid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem)));
    smem_set = smem;
  }
  attn_mid_kernel<<<dim3(H, B), ATT_THREADS, smem, st>>>(q, k, v, ld, out, lq, F, 1.0f / sqrtf((float)DH));
  return static_cast<int>(cudaGetLastError());
}
