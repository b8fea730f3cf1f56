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
// Bound on an H100 SXM at the guided batch-48 shapes (B 96, lq 111, F 512,
// 8 heads of 64): 2.4 GFLOP against 4 x 10.9 MB of q, k, v in and out:
// bound by bytes (13 us at 3.35 TB/s). So the design keeps every
// intermediate in registers and moves each byte once:
//
// - One (entry, head) item at a time per block, one warp per 16 query rows
//   (7 warps at lq 111). Q, K and V of the head (lq x 64 bf16, 14 KB each)
//   come in once by cp.async in two groups (Q and K, then V, which lands
//   while S is computed) into shared memory rows of 128 bytes in the XOR
//   swizzle of decoder_common.cuh (swz), so every ldmatrix below is free
//   of bank conflicts; q is scaled in f32 and cast
//   back to bf16 in its fragments. The grid is persistent (as many blocks
//   as the card holds at once) and each block has two such buffers: the
//   next item's Q, K and V load while this one's products run.
// - S = Q K^T runs as mma.sync m16n8k16 (bf16, f32 accumulation) with Q
//   and K fragments from ldmatrix: the warp's 16 x lp scores stay in
//   registers (lp / 2 floats a thread, 56 at lq 111).
// - The softmax reduces each row over its quad of lanes by shuffles: max,
//   one expf a score, sum; P is normalised in f32 and cast to bf16 straight
//   into the A-operand layout of the next mma (the m16n8 accumulator of two
//   key tiles is the m16k16 A fragment).
// - O = P V runs as mma.sync with V fragments from ldmatrix.trans; O is
//   cast to bf16 over the warp's own Q rows in shared memory and leaves in
//   16-byte stores, eight lanes to a 128-byte row.
// The block takes lq <= 256 (16 warps); the wrapper refuses longer rows.

#include "decoder_common.cuh"

namespace {

constexpr int ATTN_MAX_LQ = 256;

// NT: 16-row tiles of queries (one warp each) and of keys; lq <= 16 * NT.
// A persistent block walks the (entry, head) items it, it + gridDim.x, ...
// with two buffers: the next item's Q, K and V load while this one's
// products run. Up to 8 warps the registers are capped for two blocks per
// SM (ptxas gives 128 at 7 warps, with no spills), which the two buffers'
// shared memory (86 KB at lq 111) also allows.
template <int NT>
__global__ void __launch_bounds__(NT * 32, NT <= 8 ? 2 : 1)
    attn_mid_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, long ld,
                    bf16* __restrict__ out, int B, int lq, int F, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LP = 16 * NT, BUF = 3 * LP * 128;  // a buffer: Q, K, V, each [LP][64] bf16, swizzled
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, items = B * H;

  // the copies of item `it` into buffer `b` by cp.async (rows past lq
  // zero-filled) in two groups, Q and K, then V, so that S starts while V
  // is in flight; past the last item, two empty groups keep the count
  auto fetch = [&](int it, int b) {
    unsigned char* Qs = smem + b * BUF;
    const long base = (long)(it / H) * lq * ld + (it % H) * DH;
    if (it < items)
      for (int i = tid; i < LP * 8; i += NT * 32) {
        const int r = i >> 3, c = i & 7;
        const bool ok = r < lq;
        const long off = base + (ok ? r : 0) * ld + c * 8;
        cp_async16(Qs + swz(r, c), q + off, ok);
        cp_async16(Qs + LP * 128 + swz(r, c), k + off, ok);
      }
    cp_async_commit();
    if (it < items)
      for (int i = tid; i < LP * 8; i += NT * 32) {
        const int r = i >> 3, c = i & 7;
        const bool ok = r < lq;
        cp_async16(Qs + 2 * LP * 128 + swz(r, c), v + base + (ok ? r : 0) * ld + c * 8, ok);
      }
    cp_async_commit();
  };

  int b = 0;
  fetch(blockIdx.x, 0);
  for (int it = blockIdx.x; it < items; it += gridDim.x, b ^= 1) {
    fetch(it + gridDim.x, b ^ 1);  // the other buffer's item is done (the barrier at the end)
    unsigned char* Qs = smem + b * BUF;
    unsigned char* Ks = Qs + LP * 128;
    unsigned char* Vs = Ks + LP * 128;
    const int h = it % H;
    const long row0 = (long)(it / H) * lq;
    cp_async_wait<3>();  // this item's Q and K
    __syncthreads();

    // S = Q K^T: s[j] is the m16n8 accumulator of keys 8j .. 8j + 7
    const int qr = warp * 16;
    const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;  // row of an x4 load whose matrices 1, 3 are 8 rows down
    float s[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];  // q scaled by 1/sqrt(dh) in f32, then bf16 again
      ldsm_x4(smem_u32(Qs + swz(qr + lr, kk * 2 + (lane >> 4))), a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[t]));
        a[t] = pack_bf16(f.x * scale, f.y * scale);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1, b2, b3;  // keys 16j.. (b0, b1) and 16j + 8.. (b2, b3)
        ldsm_x4(smem_u32(Ks + swz(j * 16 + (lane & 7) + (lane >> 4) * 8, kk * 2 + ((lane >> 3) & 1))), b0, b1, b2,
                b3);
        mma_bf16(s[2 * j], a, b0, b1);
        mma_bf16(s[2 * j + 1], a, b2, b3);
      }
    }

    // exact softmax over the lq real keys: this lane holds rows g and g + 8
    // (g = lane / 4) at columns 8j + 2 (lane % 4) + {0, 1}
    const int c2 = 2 * (lane & 3);
    float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (8 * j + c2 + t >= lq) s[j][t] = s[j][2 + t] = -INFINITY;
        m_lo = fmaxf(m_lo, s[j][t]);
        m_hi = fmaxf(m_hi, s[j][2 + t]);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
    }
    float l_lo = 0.0f, l_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        s[j][t] = expf(s[j][t] - m_lo);
        s[j][2 + t] = expf(s[j][2 + t] - m_hi);
        l_lo += s[j][t];
        l_hi += s[j][2 + t];
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
    }
    const float i_lo = 1.0f / l_lo, i_hi = 1.0f / l_hi;
    uint32_t p[NT][4];  // P (bf16) as the A fragment of keys 16j .. 16j + 15
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      p[j][0] = pack_bf16(s[2 * j][0] * i_lo, s[2 * j][1] * i_lo);
      p[j][1] = pack_bf16(s[2 * j][2] * i_hi, s[2 * j][3] * i_hi);
      p[j][2] = pack_bf16(s[2 * j + 1][0] * i_lo, s[2 * j + 1][1] * i_lo);
      p[j][3] = pack_bf16(s[2 * j + 1][2] * i_hi, s[2 * j + 1][3] * i_hi);
    }

    cp_async_wait<2>();  // this item's V
    __syncthreads();

    // O = P V: o[n] is the m16n8 accumulator of dims 8n .. 8n + 7
    float o[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        uint32_t b0, b1, b2, b3;  // dims 16nd.. (b0, b1) and 16nd + 8.. (b2, b3)
        ldsm_x4_trans(smem_u32(Vs + swz(j * 16 + lr, nd * 2 + (lane >> 4))), b0, b1, b2, b3);
        mma_bf16(o[2 * nd], p[j], b0, b1);
        mma_bf16(o[2 * nd + 1], p[j], b2, b3);
      }
    }

    // O in bf16 over this warp's own Q rows, then 16-byte row stores
    __syncwarp();
    const int g = lane >> 2;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<uint32_t*>(Qs + swz(qr + g, n) + 2 * c2) = pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(Qs + swz(qr + g + 8, n) + 2 * c2) = pack_bf16(o[n][2], o[n][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * 8; i += 32) {
      const int r = i >> 3, c = i & 7;
      if (qr + r < lq)
        *reinterpret_cast<uint4*>(out + (row0 + qr + r) * F + h * DH + c * 8) =
            *reinterpret_cast<const uint4*>(Qs + swz(qr + r, c));
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

constexpr size_t attn_smem(int nt) { return (size_t)2 * 3 * 16 * nt * 128; }

// The persistent grid: as many blocks as the card holds at once (from the
// occupancy of this instantiation), at most one per item.
template <int NT>
cudaError_t launch_attn(const bf16* q, const bf16* k, const bf16* v, long ld, bf16* out, int B, int lq, int F, int H,
                        cudaStream_t st) {
  constexpr size_t smem = attn_smem(NT);
  static int resident = 0;  // blocks on the card at once; the limit above 48 KB is raised first
  if (resident == 0) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(attn_mid_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem)));
    int per_sm = 0;
    RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_mid_kernel<NT>, NT * 32, smem));
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = per_sm * sm_count();
  }
  const int items = B * H, grid = items < resident ? items : resident;
  attn_mid_kernel<NT><<<grid, NT * 32, smem, st>>>(q, k, v, ld, out, B, lq, F, H, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace

// The shared memory one block takes at lq (0 past the kernel's longest
// rows, which the wrapper refuses).
extern "C" size_t msmd_attn_smem_bytes(int lq) {
  return lq >= 1 && lq <= ATTN_MAX_LQ ? attn_smem((lq + 15) / 16) : 0;
}

// out (B*lq, F) bf16 = per entry and head softmax(q k^T / sqrt(64)) v, with
// q, k, v bf16 rows of stride ld (elements) and head dim 64, lq <= 256.
// Launches on `stream`; returns the first CUDA error or 0.
extern "C" int msmd_attn_forward(const bf16* q, const bf16* k, const bf16* v, long ld, bf16* out, int B, int lq,
                                 int F, int H, cudaStream_t st) {
  if (B <= 0 || lq <= 0 || lq > ATTN_MAX_LQ || F != H * DH || ld < F || ld % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((lq + 15) / 16) {
#define MSMD_ATTN_CASE(n) \
  case n:                 \
    return static_cast<int>(launch_attn<n>(q, k, v, ld, out, B, lq, F, H, st));
    MSMD_ATTN_CASE(1) MSMD_ATTN_CASE(2) MSMD_ATTN_CASE(3) MSMD_ATTN_CASE(4) MSMD_ATTN_CASE(5) MSMD_ATTN_CASE(6)
    MSMD_ATTN_CASE(7) MSMD_ATTN_CASE(8) MSMD_ATTN_CASE(9) MSMD_ATTN_CASE(10) MSMD_ATTN_CASE(11) MSMD_ATTN_CASE(12)
    MSMD_ATTN_CASE(13) MSMD_ATTN_CASE(14) MSMD_ATTN_CASE(15) MSMD_ATTN_CASE(16)
#undef MSMD_ATTN_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
