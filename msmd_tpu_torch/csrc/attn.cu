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
//
// The f32 mode (attn_f32_kernel, msmd_attn_f32_forward) is
// _attn_mid_kernel with cdt = f32, the style encoders' self-attention at
// inference (their JAX encoder is f32): q scaled by 1/sqrt(dh) in f32, f32
// scores, the exact max-subtracting softmax normalised before PV, f32 PV
// sums, f32 out. It runs f32 FMAs on the CUDA cores: TF32 keeps about three
// digits, and JAX's kernel is f32-exact. Bound on an H100 SXM at the style
// encoder's shapes (lq 100, F 512, 8 heads): 4 B lq^2 F operations against
// 16 B lq F bytes, 25 operations a byte, under the 20 of 67 TFLOP/s over
// 3.35 TB/s only by a little, so the bound is operations (0.31 us at B = 1,
// 4.9 us at B = 16). The design is the simple one, and it runs far above
// that bound by device time: at B = 1 it has 32 blocks for 132 SMs, each
// query tile stages K and V of its head again, and PV runs serially over
// the keys:
//
// - One 256-thread block per (entry, head, tile of 32 query rows). K and V
//   of the head (lq x 64 f32, 25.6 KB each at lq 100) and the tile's Q
//   (scaled on the way in) come into shared memory by 16-byte loads; K's
//   rows are padded to 65 floats, so the lanes of a warp reading 32
//   different keys at one dim hit 32 different banks.
// - Warp w takes query rows 4w .. 4w + 3, lane l the keys l + 32c
//   (c < NC): 4 x NC scores in registers, each a sum over the 64 dims in
//   order by fmaf, Q read as a broadcast float4 of 4 dims.
// - The softmax of a row reduces over the warp by shuffles (max, expf of
//   the score less the max, sum) and writes P = e / sum to the tile's P
//   rows in shared memory.
// - O = P V: lane l takes dims l and l + 32 of the warp's 4 rows, a sum
//   over the keys in order by fmaf (V rows read as consecutive floats, P as
//   a broadcast), and stores them straight to out, 128 coalesced bytes a
//   warp and row.
// Every output is one thread's sum in a fixed order: two calls give the
// same bits.

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

constexpr int F32_QT = 32;  // query rows of one f32 block: 8 warps of 4 rows

// The f32 mode's shared memory at NC key groups and lq rows: K [32 NC][65],
// V [lq][64], the tile's Q [32][64] and P [32][32 NC].
__host__ __device__ constexpr size_t attn_f32_smem(int nc, int lq) {
  return sizeof(float) * ((size_t)32 * nc * 65 + (size_t)lq * DH + F32_QT * DH + (size_t)F32_QT * 32 * nc);
}

template <int NC>
__global__ void __launch_bounds__(256) attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                                       const float* __restrict__ v, long ld, float* __restrict__ out,
                                                       int lq, int F, int H, int tiles, float scale) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int KP = 32 * NC;  // key rows, those past lq zero
  float* Ks = fsm;             // [KP][65]
  float* Vs = Ks + KP * 65;    // [lq][64]
  float* Qs = Vs + lq * DH;    // [F32_QT][64], scaled
  float* Ps = Qs + F32_QT * DH;  // [F32_QT][KP]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x % tiles, eh = blockIdx.x / tiles, h = eh % H, e = eh / H;
  const int q0 = tile * F32_QT, nq = min(F32_QT, lq - q0);
  const long base = (long)e * lq * ld + (long)h * DH;

  for (int i = tid; i < KP * (DH / 4); i += 256) {
    const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
    float4 kv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < lq) {
      kv = *reinterpret_cast<const float4*>(k + base + (long)r * ld + c);
      *reinterpret_cast<float4*>(Vs + r * DH + c) = *reinterpret_cast<const float4*>(v + base + (long)r * ld + c);
    }
    float* kr = Ks + r * 65 + c;
    kr[0] = kv.x;
    kr[1] = kv.y;
    kr[2] = kv.z;
    kr[3] = kv.w;
  }
  for (int i = tid; i < F32_QT * (DH / 4); i += 256) {
    const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
    float4 qv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < nq) qv = *reinterpret_cast<const float4*>(q + base + (long)(q0 + r) * ld + c);
    qv.x *= scale;
    qv.y *= scale;
    qv.z *= scale;
    qv.w *= scale;
    *reinterpret_cast<float4*>(Qs + r * DH + c) = qv;
  }
  __syncthreads();

  const int r0 = warp * 4;
  if (r0 >= nq) return;  // no barrier follows: a warp past the tile's rows is done
  float s[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) s[i][c] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 qd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qd[i] = *reinterpret_cast<const float4*>(Qs + (r0 + i) * DH + d);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* kr = Ks + (lane + 32 * c) * 65 + d;
      const float k0 = kr[0], k1 = kr[1], k2 = kr[2], k3 = kr[3];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = fmaf(qd[i].x, k0, s[i][c]);
        a = fmaf(qd[i].y, k1, a);
        a = fmaf(qd[i].z, k2, a);
        s[i][c] = fmaf(qd[i].w, k3, a);
      }
    }
  }

  // exact softmax of each row over its lq real keys
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane + 32 * c < lq) m = fmaxf(m, s[i][c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      s[i][c] = lane + 32 * c < lq ? expf(s[i][c] - m) : 0.0f;
      l += s[i][c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int c = 0; c < NC; ++c) Ps[(r0 + i) * KP + lane + 32 * c] = s[i][c] / l;
  }
  __syncwarp();  // a warp reads only its own P rows

  float o[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i][0] = o[i][1] = 0.0f;
  for (int j = 0; j < lq; ++j) {
    const float v0 = Vs[j * DH + lane], v1 = Vs[j * DH + lane + 32];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = Ps[(r0 + i) * KP + j];
      o[i][0] = fmaf(p, v0, o[i][0]);
      o[i][1] = fmaf(p, v1, o[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (r0 + i < nq) {
      float* orow = out + ((long)e * lq + q0 + r0 + i) * F + (long)h * DH;
      orow[lane] = o[i][0];
      orow[lane + 32] = o[i][1];
    }
}

template <int NC>
cudaError_t launch_attn_f32(const float* q, const float* k, const float* v, long ld, float* out, int B, int lq, int F,
                            int H, cudaStream_t st) {
  static bool ready = false;  // the limit above 48 KB, raised once for the longest rows of NC
  if (!ready) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(attn_f32_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(attn_f32_smem(NC, 32 * NC))));
    ready = true;
  }
  const int tiles = (lq + F32_QT - 1) / F32_QT;
  const long blocks = (long)B * H * tiles;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  attn_f32_kernel<NC><<<(unsigned)blocks, 256, attn_f32_smem(NC, lq), st>>>(q, k, v, ld, out, lq, F, H, tiles,
                                                                           1.0f / sqrtf((float)DH));
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

// The shared memory one block of the f32 mode takes at lq (0 past the
// kernel's longest rows).
extern "C" size_t msmd_attn_f32_smem_bytes(int lq) {
  return lq >= 1 && lq <= ATTN_MAX_LQ ? attn_f32_smem((lq + 31) / 32, lq) : 0;
}

// out (B*lq, F) f32 = per entry and head softmax(q k^T / sqrt(64)) v in f32,
// with q, k, v f32 rows of stride ld (elements, a multiple of 4) and head
// dim 64, lq <= 256. Launches on `stream`; returns the first CUDA error or 0.
extern "C" int msmd_attn_f32_forward(const float* q, const float* k, const float* v, long ld, float* out, int B,
                                     int lq, int F, int H, cudaStream_t st) {
  if (B <= 0 || lq <= 0 || lq > ATTN_MAX_LQ || F != H * DH || ld < F || ld % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((lq + 31) / 32) {
#define MSMD_ATTN_F32_CASE(n) \
  case n:                     \
    return static_cast<int>(launch_attn_f32<n>(q, k, v, ld, out, B, lq, F, H, st));
    MSMD_ATTN_F32_CASE(1) MSMD_ATTN_F32_CASE(2) MSMD_ATTN_F32_CASE(3) MSMD_ATTN_F32_CASE(4)
    MSMD_ATTN_F32_CASE(5) MSMD_ATTN_F32_CASE(6) MSMD_ATTN_F32_CASE(7) MSMD_ATTN_F32_CASE(8)
#undef MSMD_ATTN_F32_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
