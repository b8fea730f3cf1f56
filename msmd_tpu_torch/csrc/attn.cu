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
// sums, f32 out. Bound on an H100 SXM at the style encoder's shapes (lq
// 100, F 512, 8 heads): 4 B lq^2 F operations against 16 B lq F bytes;
// on the CUDA cores (67 TFLOP/s) that is operations, 0.31 us at B = 1 and
// 4.9 us at B = 16. f32 FMAs on the CUDA cores (one thread's sum an
// output, then register tiles of 4 rows x 7 keys a lane) stayed bound by
// the shared-memory loads that feed the FMAs. This kernel runs both products on
// the tensor cores at f32 accuracy, as K5 does (csrc/lbs.cu): each operand
// x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and a
// product is lo.hi + hi.lo + hi.hi, three TF32 mma.sync, summed in f32
// (ops/kernels/attn.py::attention_middle_f32_model is its arithmetic; TF32
// alone keeps about three digits). Its bound is then the bytes, 16 B lq F
// at 3.35 TB/s: 3.9 us at B = 16.
//
// - One CTA per (entry, head, 64 query rows), 4 warps of 16 rows (one
//   wave of 256 CTAs at B = 16, two an SM; CTAs of 2 warps ran 1.6x
//   slower at B = 16 and 1.1x at B = 1). Its
//   threads copy the head's K and V (lq x 64 f32, 25.6 KB each at lq 100)
//   and their Q rows into shared memory by 16-byte cp.async, Q and K in one
//   group and V in a second that lands while the scores run; rows past lq
//   are zero-filled. Rows are padded to 68 floats, so ldmatrix and the V
//   loads below are free of bank conflicts. (A cluster per (entry, head)
//   with K and V multicast by TMA bulk copies, one 256-byte row a copy,
//   spent 5.5-6 us a CTA in those copies on the card's clock: the L2
//   traffic it saves costs far less.)
// - Warp w owns query rows 16w .. 16w + 15 of its CTA in every phase (one
//   block barrier after each copy group). S = Q K^T runs as m16n8k8 TF32
//   mma.sync, 8 dims a step, its Q and K fragments read by ldmatrix (an
//   8 x 8 b16 matrix is 8 rows of 4 floats). Q is split in registers; K
//   and V are split once for the CTA's warps, each into its hi plane in
//   place and its lo plane in a third buffer (K's, then V's after the
//   scores). The warp's 16 x lp scores stay in registers (lp / 2 floats a
//   lane).
// - The softmax reduces each row over its quad of lanes by shuffles: max,
//   expf of the score less the max, sum; P = e (1 / sum) stays in
//   registers.
// - O = P V as m16n8k8 TF32 mma.sync, 8 keys a step: P's accumulator tile
//   is the A fragment with its keys in the order 0, 2, 4, 6, 1, 3, 5, 7, so
//   V's fragment is read for keys 2t and 2t + 1 straight from shared
//   memory. O leaves in 8-byte stores, whole 32-byte sectors.
// Every output is the same products and sums in the same order on every
// call: two calls give the same bits. With `stamps`, thread 0 of each CTA
// records the card's clock after each phase (Q and K landed and K split,
// scores, softmax, V split with PV and the store) and the whole run in
// cycles and in ns.

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

constexpr int F32_ROWS = 16;  // query rows of one warp of the f32 mode: one m16 tile
constexpr int F32_WARPS = 4;  // warps of one CTA of the f32 mode
constexpr int F32_LD = DH + 4;  // floats a row of Q, K and V in shared memory
constexpr int F32_STAMPS = 6;   // per CTA: cycles of 4 phases and the whole run; ns of the whole run

// The f32 mode's keys (lq to a multiple of 16: pairs of 8-key tiles),
// CTAs a head and shared memory a CTA at lq: K, V and the lo plane
// [kp][68], Q [64][68].
__host__ __device__ constexpr int f32_kp(int lq) { return (lq + 15) / 16 * 16; }
__host__ __device__ constexpr int f32_ctas(int lq) {
  return (lq + F32_ROWS * F32_WARPS - 1) / (F32_ROWS * F32_WARPS);
}
__host__ __device__ constexpr size_t attn_f32_smem(int lq) {
  return sizeof(float) * (size_t)(3 * f32_kp(lq) + F32_ROWS * F32_WARPS) * F32_LD;
}

__device__ __forceinline__ long long attn_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// x = hi + lo + O(2^-22 |x|): hi = x rounded to TF32, lo = the rest rounded
// to TF32 (as K5's split, ops/kernels/lbs.py::tf32_split_plain)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a b over 8 of k in TF32, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at f32 accuracy: lo.hi + hi.lo + hi.hi, each a TF32 product
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2], const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, ahi, bhi[0], bhi[1]);
}

template <int NC>
__global__ void __launch_bounds__(F32_WARPS * 32)
    attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, long ld,
                    float* __restrict__ out, int lq, int F, int H, float scale, long long* stamps) {
  constexpr int KP = 16 * NC, NT = 2 * NC, ROWS = F32_ROWS * F32_WARPS, THREADS = F32_WARPS * 32;  // NT: 8-key tiles
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Ks = fsm;               // [KP][F32_LD] K, then its hi plane; rows past lq zero
  float* Vs = Ks + KP * F32_LD;  // [KP][F32_LD] V, then its hi plane; rows past lq zero
  float* Xs = Vs + KP * F32_LD;  // [KP][F32_LD] K's lo plane, then V's
  float* Qs = Xs + KP * F32_LD;  // [ROWS][F32_LD]; rows past this CTA's zero
  const int ctas = f32_ctas(lq), eh = blockIdx.x / ctas, h = eh % H, e = eh / H;
  const int q0 = (blockIdx.x % ctas) * ROWS, nq = min(ROWS, lq - q0);
  const long base = (long)e * lq * ld + (long)h * DH;
  long long clk[5] = {0, 0, 0, 0, 0}, ns0 = 0, ns1 = 0;
  if (stamps && tid == 0) {
    clk[0] = clock64();
    ns0 = attn_ns();
  }

  // 16-byte copies, 16 a row: Q and K in one group, V in a second that
  // lands while the scores run; rows past the real ones zero-filled
  for (int i = tid; i < ROWS * 16; i += THREADS) {
    const int r = i >> 4, c = (i & 15) * 4;
    cp_async16(Qs + r * F32_LD + c, q + base + (long)(q0 + (r < nq ? r : 0)) * ld + c, r < nq);
  }
  for (int i = tid; i < KP * 16; i += THREADS) {
    const int r = i >> 4, c = (i & 15) * 4;
    cp_async16(Ks + r * F32_LD + c, k + base + (long)(r < lq ? r : 0) * ld + c, r < lq);
  }
  cp_async_commit();
  for (int i = tid; i < KP * 16; i += THREADS) {
    const int r = i >> 4, c = (i & 15) * 4;
    cp_async16(Vs + r * F32_LD + c, v + base + (long)(r < lq ? r : 0) * ld + c, r < lq);
  }
  cp_async_commit();
  // x (K, then V) into its TF32 planes, once for the CTA's warps: hi in
  // place, lo in Xs
  auto split_rows = [&](float* x) {
    for (int i = tid; i < KP * 16; i += THREADS) {
      const int o = (i >> 4) * F32_LD + (i & 15) * 4;
      const float4 f = *reinterpret_cast<const float4*>(x + o);
      uint32_t h[4], l[4];
      split_tf32(f.x, h[0], l[0]);
      split_tf32(f.y, h[1], l[1]);
      split_tf32(f.z, h[2], l[2]);
      split_tf32(f.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(x + o) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(Xs + o) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  };
  cp_async_wait<1>();
  __syncthreads();
  split_rows(Ks);
  __syncthreads();
  if (stamps && tid == 0) clk[1] = clock64();

  // the m16n8k8 fragments: this lane holds rows g and g + 8 of the warp's
  // tile at columns 2t, 2t + 1 of each 8-wide accumulator tile
  const int r0 = warp * F32_ROWS, g = lane >> 2, t = lane & 3;
  const bool rows_here = r0 < nq;
  float s[NT][4];  // the scores, then P: tile j holds keys 8j .. 8j + 7
  if (rows_here) {
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    // S = (q / sqrt(dh)) k^T, 8 dims a step; ldmatrix of f32 rows gives the
    // TF32 fragments: an 8 x 8 b16 matrix is 8 rows of 4 floats
    const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;  // A: matrices 1, 3 are 8 rows down, 2, 3 4 dims on
    const int kr = (lane & 7) + (lane >> 4) * 8;        // B: matrices 2, 3 are the next 8 keys
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      uint32_t a[4], ahi[4], alo[4];
      ldsm_x4(smem_u32(Qs + (r0 + lr) * F32_LD + kk * 8 + (lane >> 4) * 4), a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]) * scale, ahi[i], alo[i]);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        uint32_t bhi[2][2], blo[2][2];  // keys 16j.. ([0]), 16j + 8.. ([1])
        const int o = (16 * j + kr) * F32_LD + kk * 8 + ((lane >> 3) & 1) * 4;
        ldsm_x4(smem_u32(Ks + o), bhi[0][0], bhi[0][1], bhi[1][0], bhi[1][1]);
        ldsm_x4(smem_u32(Xs + o), blo[0][0], blo[0][1], blo[1][0], blo[1][1]);
        mma_3xtf32(s[2 * j], ahi, alo, bhi[0], blo[0]);
        mma_3xtf32(s[2 * j + 1], ahi, alo, bhi[1], blo[1]);
      }
    }
    if (stamps && tid == 0) clk[2] = clock64();

    // exact softmax of rows g and g + 8 over the lq real keys, within the
    // quad of lanes that holds them; P = e (1 / sum)
    float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (8 * j + 8 > lq)  // the tile past the last key: its padded keys score -inf, so e = 0 there
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (8 * j + 2 * t + c >= lq) s[j][c] = s[j][2 + c] = -INFINITY;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        m_lo = fmaxf(m_lo, s[j][c]);
        m_hi = fmaxf(m_hi, s[j][2 + c]);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
    }
    float l_lo = 0.0f, l_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[j][c] = expf(s[j][c] - m_lo);
        s[j][2 + c] = expf(s[j][2 + c] - m_hi);
        l_lo += s[j][c];
        l_hi += s[j][2 + c];
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
    }
    const float i_lo = 1.0f / l_lo, i_hi = 1.0f / l_hi;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] *= i_lo;
      s[j][1] *= i_lo;
      s[j][2] *= i_hi;
      s[j][3] *= i_hi;
    }
    if (stamps && tid == 0) clk[3] = clock64();
  }
  cp_async_wait<0>();
  __syncthreads();  // V landed, and every warp is done with K's lo plane
  split_rows(Vs);
  __syncthreads();
  if (rows_here) {
    // O = P V, 8 keys a step. P's accumulator tile is the A fragment with
    // its 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7 (a0 = key 2t, a2 =
    // key 2t + 1), so V's fragment takes keys 2t and 2t + 1: b0 =
    // V[8j + 2t][8n + g], b1 = V[8j + 2t + 1][8n + g] (conflict-free at
    // the 68-float row stride)
    float o[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t phi[4], plo[4];
      split_tf32(s[j][0], phi[0], plo[0]);
      split_tf32(s[j][2], phi[1], plo[1]);
      split_tf32(s[j][1], phi[2], plo[2]);
      split_tf32(s[j][3], phi[3], plo[3]);
      const int vr = (8 * j + 2 * t) * F32_LD + g;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const uint32_t vhi[2] = {__float_as_uint(Vs[vr + 8 * n]), __float_as_uint(Vs[vr + F32_LD + 8 * n])};
        const uint32_t vlo[2] = {__float_as_uint(Xs[vr + 8 * n]), __float_as_uint(Xs[vr + F32_LD + 8 * n])};
        mma_3xtf32(o[n], phi, plo, vhi, vlo);
      }
    }
    const int r = r0 + g;
    float* orow = out + ((long)e * lq + q0 + r) * F + (long)h * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      if (r < nq) *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(o[n][0], o[n][1]);
      if (r + 8 < nq) *reinterpret_cast<float2*>(orow + 8 * F + 8 * n) = make_float2(o[n][2], o[n][3]);
    }
    if (stamps && tid == 0) {
      clk[4] = clock64();
      ns1 = attn_ns();
    }
  }
  if (stamps && tid == 0) {
    long long* st = stamps + (long)F32_STAMPS * blockIdx.x;
    st[0] = clk[1] - clk[0];
    st[1] = clk[2] - clk[1];
    st[2] = clk[3] - clk[2];
    st[3] = clk[4] - clk[3];
    st[4] = clk[4] - clk[0];
    st[5] = ns1 - ns0;
  }
}

template <int NC>
cudaError_t launch_attn_f32(const float* q, const float* k, const float* v, long ld, float* out, int B, int lq, int F,
                            int H, long long* stamps, cudaStream_t st) {
  static bool ready = false;  // the limit above 48 KB, raised once for the longest rows of NC
  if (!ready) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(attn_f32_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(attn_f32_smem(16 * NC))));
    ready = true;
  }
  const long grid = (long)B * H * f32_ctas(lq);
  if (grid > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  attn_f32_kernel<NC><<<static_cast<unsigned>(grid), F32_WARPS * 32, attn_f32_smem(lq), st>>>(
      q, k, v, ld, out, lq, F, H, 1.0f / sqrtf(static_cast<float>(DH)), stamps);
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

// The f32 mode's launch at (B, lq, H), as ops/kernels/attn.py::
// attn_f32_plan gives it: plan[0..5] = grid CTAs, CTAs a head, threads a
// CTA, query rows a CTA, pairs of 8-key tiles, shared memory a CTA.
// Returns cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int msmd_attn_f32_plan(int B, int lq, int H, long* plan) {
  if (B <= 0 || H <= 0 || lq <= 0 || lq > ATTN_MAX_LQ) return static_cast<int>(cudaErrorInvalidValue);
  const long out[6] = {(long)B * H * f32_ctas(lq), f32_ctas(lq), 32 * F32_WARPS, F32_ROWS * F32_WARPS,
                       f32_kp(lq) / 16, static_cast<long>(attn_f32_smem(lq))};
  for (int i = 0; i < 6; ++i) plan[i] = out[i];
  return 0;
}

// out (B*lq, F = 64 H) f32 = per entry and head softmax(q k^T / sqrt(64)) v
// at f32 accuracy, with q, k, v f32 rows of stride ld (elements, a multiple
// of 4; 16-byte aligned) and head dim 64, lq <= 256. stamps: null, or
// F32_STAMPS int64 per CTA (the card's clock by phase). Launches on
// `stream`; returns the first CUDA error or 0.
extern "C" int msmd_attn_f32_forward(const float* q, const float* k, const float* v, long ld, float* out, int B,
                                     int lq, int H, long long* stamps, cudaStream_t st) {
  const int F = H * DH;
  if (B <= 0 || lq <= 0 || lq > ATTN_MAX_LQ || H <= 0 || ld < F || ld % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (f32_kp(lq) / 16) {
#define MSMD_ATTN_F32_CASE(n) \
  case n:                     \
    return static_cast<int>(launch_attn_f32<n>(q, k, v, ld, out, B, lq, F, H, stamps, st));
    MSMD_ATTN_F32_CASE(1) MSMD_ATTN_F32_CASE(2) MSMD_ATTN_F32_CASE(3) MSMD_ATTN_F32_CASE(4)
    MSMD_ATTN_F32_CASE(5) MSMD_ATTN_F32_CASE(6) MSMD_ATTN_F32_CASE(7) MSMD_ATTN_F32_CASE(8)
    MSMD_ATTN_F32_CASE(9) MSMD_ATTN_F32_CASE(10) MSMD_ATTN_F32_CASE(11) MSMD_ATTN_F32_CASE(12)
    MSMD_ATTN_F32_CASE(13) MSMD_ATTN_F32_CASE(14) MSMD_ATTN_F32_CASE(15) MSMD_ATTN_F32_CASE(16)
#undef MSMD_ATTN_F32_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
