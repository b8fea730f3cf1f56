// K10: WavLM's gated relative-position self-attention, forward and
// backward, hand-written for Hopper (sm_90a) and bound to PyTorch through a
// plain C interface (ops/kernels/relpos_attn.py).
//
// Per entry b and head h, from projected q, k, v (B, L, H, 64) bf16, the
// gate g (B, H, L) and the head's table of offsets r (H, 2L - 1), both f32:
//
//   S[i, j] = q_i . k_j / 8 + g[b, h, i] r[h, j - i + L - 1]
//   out_i   = sum_j softmax_j(S[i, :]) v_j
//
// K10 replaces no TPU kernel (the JAX package has no WavLM). No kernel of
// the port took an additive bias, and PyTorch's flash attention takes
// none: given a float mask, scaled_dot_product_attention writes the
// (B H, L, L) bias and its gradient in every layer.
//
// Bound on an H100 SXM at the WavLM-Large cell's shapes (B 32, L 200, 16
// heads of 64): about 100 operations a byte of q, k, v, out (and dout, dq,
// dk, dv), against the card's 295 for bf16 on the tensor cores: bytes. So
// every L x L tile (scores, bias, probabilities, dS) stays in registers and
// only those bytes move.
//
// Every kernel runs CTAs of 4 warps, one warp per 16 rows of a 64-row
// tile, the products as mma.sync m16n8k16 (bf16, f32 sums) with fragments
// from ldmatrix over [64][64] bf16 tiles in the XOR swizzle of
// decoder_common.cuh (swz), free of bank conflicts, as K8 (attn.cu) does.
// Tiles come in by cp.async (rows past L zero-filled); the tiles a CTA
// walks are double-buffered, so the next lands while this one's products
// run. The head's row of r is staged in shared memory with 64 zeros on
// each side, so the bias of any (i, j) of a tile, padding rows included,
// is one load: g_i rz[j - i].
//
// - k10_relpos_fwd: a CTA per (entry, head, 64 query rows) walks the key
//   tiles of 64. S = Q K^T, the bias g_i r from shared memory, the online
//   softmax in f32 (base 2, each row's max and sum within its quad of
//   lanes), P rounded to bf16 (running, unnormalised) straight into the A
//   fragments of O += P V. Writes out (bf16) and each row's log-sum-exp.
// - k10_relpos_bwd_pre: delta_i = dout_i . out_i, eight lanes a row.
// - k10_relpos_bwd_dkdv: a CTA per (entry, head, 64 keys) walks the query
//   tiles: S^T = K Q^T, P^T from the forward's log-sum-exp, dV += P^T dO,
//   dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
// - k10_relpos_bwd_dq: a CTA per (entry, head, 64 query rows) walks the
//   key tiles: S and P again, dP = dO V^T, dS, dQ += dS K, dg_i += sum_j
//   dS_ij r[j - i] (f32), and the tile's g_i dS_ij into an f32 scratch tile
//   whose 127 diagonals 127 threads sum, each in row order, into the CTA's
//   row of partial dr sums in shared memory (registers cannot be read along
//   a diagonal). The row goes out whole at the end.
// - k10_relpos_bwd_dr: dr[h, d] = the sum of the partial rows over entries
//   and query tiles, in that order, a thread a column.
// No float atomics, and every sum runs in a fixed order: two calls give the
// same bits.
//
// Rounding (ops/kernels/relpos_attn.py's plain versions round alike): S in
// f32 from the bf16 operands, scaled by 1/8 (exact) before the bias is
// added; the softmax in f32; P rounded to bf16 for the PV and dV products;
// dS rounded to bf16 for the dQ and dK products; dg and dr from the f32 dS.

#include "decoder_common.cuh"

namespace {

constexpr int K10_ROWS = 64;      // rows of a tile: query rows, or keys in the dkdv pass
constexpr int K10_THREADS = 128;  // 4 warps of 16 rows
constexpr int K10_TILE = K10_ROWS * 128;  // bytes of a [64][64] bf16 tile
constexpr int K10_MAX_L = 2048;
constexpr int K10_PAD = 64;    // zeros on each side of the staged row of r
constexpr int DIAG_LD = 72;    // floats a row of the dq pass's scratch tile: its float2 stores are free of conflicts
constexpr float K10_LOG2E = 1.4426950408889634f;
constexpr float K10_LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int k10_tiles(int L) { return (L + K10_ROWS - 1) / K10_ROWS; }
// floats of the staged row of r (rounded to 4, so what follows stays 16-byte aligned)
__host__ __device__ constexpr int k10_r_floats(int L) { return (2 * L - 1 + 2 * K10_PAD + 3) / 4 * 4; }
// floats of a CTA's row of partial dr sums: offsets -(i0 + 63) .. L - 1 - i0 of query tile i0
__host__ __device__ constexpr int k10_part_width(int L) { return L + K10_ROWS; }

constexpr size_t fwd_smem(int L) { return (size_t)5 * K10_TILE + 4 * (size_t)k10_r_floats(L); }
constexpr size_t dkdv_smem(int L) {
  return (size_t)6 * K10_TILE + 4 * (size_t)(2 * 3 * K10_ROWS) + 4 * (size_t)k10_r_floats(L);
}
constexpr size_t dq_smem(int L) {
  return (size_t)6 * K10_TILE + 4 * (size_t)(K10_ROWS * DIAG_LD + k10_r_floats(L) + k10_part_width(L));
}

// rows row0 .. row0 + 63 of one head of a (B, L, H, 64) bf16 tensor (src:
// its row 0) into a swizzled [64][64] tile by cp.async; rows past L zero
__device__ __forceinline__ void k10_load_tile(unsigned char* dst, const bf16* src, long ld, int row0, int L, int tid) {
  for (int i = tid; i < K10_ROWS * 8; i += K10_THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = row0 + r < L;
    cp_async16(dst + swz(r, c), src + (long)(ok ? row0 + r : 0) * ld + c * 8, ok);
  }
}

// the head's row of r (2L - 1 floats) with K10_PAD zeros on each side;
// returns rz with rz[d] = r[d + L - 1] for -(L + 63) <= d <= L + 63
__device__ __forceinline__ const float* stage_r(float* rs, const float* r_h, int L, int tid) {
  for (int i = tid; i < k10_r_floats(L); i += K10_THREADS) {
    const int c = i - K10_PAD;
    rs[i] = c >= 0 && c < 2 * L - 1 ? r_h[c] : 0.0f;
  }
  return rs + K10_PAD + L - 1;
}

// the A fragment of rows r0 .. r0 + 15, k 16 kk .. 16 kk + 15 of a tile
__device__ __forceinline__ void frag_a(const unsigned char* t, int r0, int kk, int lane, uint32_t (&a)[4]) {
  ldsm_x4(smem_u32(t + swz(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, kk * 2 + (lane >> 4))), a[0], a[1], a[2], a[3]);
}

// s (16 x 64) = a (16 x 64, four A fragments) t^T: t's rows are the columns
__device__ __forceinline__ void mma_abt(float (&s)[8][4], const uint32_t (&a)[4][4], const unsigned char* t,
                                        int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b0, b1, b2, b3;  // columns 16j.. (b0, b1) and 16j + 8.. (b2, b3)
      ldsm_x4(smem_u32(t + swz(j * 16 + (lane & 7) + (lane >> 4) * 8, kk * 2 + ((lane >> 3) & 1))), b0, b1, b2, b3);
      mma_bf16(s[2 * j], a[kk], b0, b1);
      mma_bf16(s[2 * j + 1], a[kk], b2, b3);
    }
  }
}

// o (16 x 64) += a (16 x 64, four A fragments) t: t's rows are the k
__device__ __forceinline__ void mma_ab(float (&o)[8][4], const uint32_t (&a)[4][4], const unsigned char* t,
                                       int lane) {
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
      uint32_t b0, b1, b2, b3;  // columns 16nd.. (b0, b1) and 16nd + 8.. (b2, b3)
      ldsm_x4_trans(smem_u32(t + swz(j * 16 + lr, nd * 2 + (lane >> 4))), b0, b1, b2, b3);
      mma_bf16(o[2 * nd], a[j], b0, b1);
      mma_bf16(o[2 * nd + 1], a[j], b2, b3);
    }
  }
}

// a 16 x 64 accumulator tile in bf16 as four A fragments (the m16n8
// accumulators of columns 16j and 16j + 8 make the m16k16 fragment j)
__device__ __forceinline__ void to_frags(const float (&s)[8][4], uint32_t (&p)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    p[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    p[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    p[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// this warp's 16 rows (r0 ..) of o, times mlo (rows g) and mhi (rows g + 8),
// in bf16 over the same rows of tile t, then out to rows row0 + r0 .. of dst
__device__ __forceinline__ void store_rows(bf16* dst, long ld, unsigned char* t, const float (&o)[8][4], float mlo,
                                           float mhi, int r0, int row0, int L, int lane) {
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(t + swz(r0 + g, n) + 2 * c2) = pack_bf16(o[n][0] * mlo, o[n][1] * mlo);
    *reinterpret_cast<uint32_t*>(t + swz(r0 + g + 8, n) + 2 * c2) = pack_bf16(o[n][2] * mhi, o[n][3] * mhi);
  }
  __syncwarp();
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3, c = i & 7;
    if (row0 + r0 + r < L)
      *reinterpret_cast<uint4*>(dst + (long)(row0 + r0 + r) * ld + c * 8) =
          *reinterpret_cast<const uint4*>(t + swz(r0 + r, c));
  }
}

__global__ void __launch_bounds__(K10_THREADS)
    k10_relpos_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const float* __restrict__ gate, const float* __restrict__ r, bf16* __restrict__ out,
                   float* __restrict__ lse, int L, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;             // the CTA's query rows, then its output
  unsigned char* KV = smem + K10_TILE;  // two buffers of a K and a V tile
  float* rs = reinterpret_cast<float*>(smem + 5 * K10_TILE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c2 = 2 * (lane & 3);
  const int bh = blockIdx.x, b = bh / H, h = bh % H, i0 = blockIdx.y * K10_ROWS, nk = k10_tiles(L);
  const long ld = (long)H * DH, base = (long)b * L * ld + (long)h * DH;

  k10_load_tile(Qs, q + base, ld, i0, L, tid);
  k10_load_tile(KV, k + base, ld, 0, L, tid);
  k10_load_tile(KV + K10_TILE, v + base, ld, 0, L, tid);
  cp_async_commit();
  const float* rz = stage_r(rs, r + (long)h * (2 * L - 1), L, tid);
  const int ilo = i0 + warp * 16 + g, ihi = ilo + 8;  // this lane's rows
  const float glo = ilo < L ? gate[(long)bh * L + ilo] : 0.0f, ghi = ihi < L ? gate[(long)bh * L + ihi] : 0.0f;

  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;  // log2 domain; l: this lane's share
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  uint32_t qf[4][4];
  for (int t = 0; t < nk; ++t) {
    const unsigned char* Ks = KV + (t & 1) * 2 * K10_TILE;
    const unsigned char* Vs = Ks + K10_TILE;
    if (t + 1 < nk) {  // the other buffer was freed by the barrier that ended tile t - 1
      unsigned char* nxt = KV + ((t + 1) & 1) * 2 * K10_TILE;
      k10_load_tile(nxt, k + base, ld, (t + 1) * K10_ROWS, L, tid);
      k10_load_tile(nxt + K10_TILE, v + base, ld, (t + 1) * K10_ROWS, L, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) frag_a(Qs, warp * 16, kk, lane, qf[kk]);

    float s[8][4];
    mma_abt(s, qf, Ks, lane);
    const int j0 = t * K10_ROWS;
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 8 * n + c2 + e;
        const bool ok = j < L;
        s[n][e] = ok ? (s[n][e] * scale + glo * rz[j - ilo]) * K10_LOG2E : -INFINITY;
        s[n][2 + e] = ok ? (s[n][2 + e] * scale + ghi * rz[j - ihi]) * K10_LOG2E : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[n][e]);
        mx_hi = fmaxf(mx_hi, s[n][2 + e]);
      }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float a_lo = exp2f(m_lo - mx_lo), a_hi = exp2f(m_hi - mx_hi);
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = exp2f(s[n][e] - mx_lo);
        s[n][2 + e] = exp2f(s[n][2 + e] - mx_hi);
        l_lo += s[n][e];
        l_hi += s[n][2 + e];
      }
      o[n][0] *= a_lo;
      o[n][1] *= a_lo;
      o[n][2] *= a_hi;
      o[n][3] *= a_hi;
    }
    m_lo = mx_lo;
    m_hi = mx_hi;
    uint32_t pf[4][4];
    to_frags(s, pf);
    mma_ab(o, pf, Vs, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  // each warp read only its own rows of Qs, so it may write its output there
  store_rows(out + base, ld, Qs, o, 1.0f / l_lo, 1.0f / l_hi, warp * 16, i0, L, lane);
  if ((lane & 3) == 0) {
    if (ilo < L) lse[(long)bh * L + ilo] = (m_lo + log2f(l_lo)) * K10_LN2;
    if (ihi < L) lse[(long)bh * L + ihi] = (m_hi + log2f(l_hi)) * K10_LN2;
  }
}

// delta[b, h, i] = dout . out over the row's 64 dims, eight lanes a row of
// the (B, L, H) rows
__global__ void __launch_bounds__(256) k10_relpos_bwd_pre(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                                                          float* __restrict__ delta, long rows, int L, int H) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x, row = t >> 3;
  const int part = static_cast<int>(t & 7);
  float s = 0.0f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(out + row * DH + part * 8);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + row * DH + part * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(d2[i]);
      s += x.x * y.x + x.y * y.y;
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  if (row < rows && part == 0) {
    const long bi = row / H;  // b L + i
    delta[((bi / L) * H + row % H) * L + bi % L] = s;
  }
}

__global__ void __launch_bounds__(K10_THREADS)
    k10_relpos_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const float* __restrict__ gate, const float* __restrict__ r, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int L, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Ks = smem;  // the CTA's keys, then dK
  unsigned char* Vs = smem + K10_TILE;  // its values, then dV
  unsigned char* QD = smem + 2 * K10_TILE;  // two buffers of a Q and a dO tile
  float* rows = reinterpret_cast<float*>(smem + 6 * K10_TILE);  // two buffers of g, lse log2(e), delta [3][64]
  float* rs = rows + 2 * 3 * K10_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c2 = 2 * (lane & 3);
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j0 = blockIdx.y * K10_ROWS, nq = k10_tiles(L);
  const long ld = (long)H * DH, base = (long)b * L * ld + (long)h * DH;

  // a query tile's rows: g, lse log2(e) (+inf past L: P^T is 0 there) and delta
  auto fetch = [&](int t) {
    const int buf = t & 1, i0 = t * K10_ROWS;
    k10_load_tile(QD + buf * 2 * K10_TILE, q + base, ld, i0, L, tid);
    k10_load_tile(QD + buf * 2 * K10_TILE + K10_TILE, dout + base, ld, i0, L, tid);
    cp_async_commit();
    if (tid < K10_ROWS) {
      const int i = i0 + tid;
      float* rw = rows + buf * 3 * K10_ROWS;
      const bool ok = i < L;
      rw[tid] = ok ? gate[(long)bh * L + i] : 0.0f;
      rw[K10_ROWS + tid] = ok ? lse[(long)bh * L + i] * K10_LOG2E : INFINITY;
      rw[2 * K10_ROWS + tid] = ok ? delta[(long)bh * L + i] : 0.0f;
    }
  };
  k10_load_tile(Ks, k + base, ld, j0, L, tid);
  k10_load_tile(Vs, v + base, ld, j0, L, tid);
  fetch(0);
  const float* rz = stage_r(rs, r + (long)h * (2 * L - 1), L, tid);
  const int jlo = j0 + warp * 16 + g, jhi = jlo + 8;  // this lane's keys

  float dkt[8][4], dvt[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dkt[n][c] = dvt[n][c] = 0.0f;
  uint32_t kf[4][4], vf[4][4];
  for (int t = 0; t < nq; ++t) {
    if (t + 1 < nq) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        frag_a(Ks, warp * 16, kk, lane, kf[kk]);
        frag_a(Vs, warp * 16, kk, lane, vf[kk]);
      }
    const unsigned char* Qt = QD + (t & 1) * 2 * K10_TILE;
    const unsigned char* Dt = Qt + K10_TILE;
    const float* rw = rows + (t & 1) * 3 * K10_ROWS;
    const int i0 = t * K10_ROWS;

    float st[8][4];  // S^T, then P^T: keys (rows) x queries (columns)
    mma_abt(st, kf, Qt, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + c2 + e, i = i0 + c;
        const float gi = rw[c], li = rw[K10_ROWS + c];
        st[n][e] = exp2f((st[n][e] * scale + gi * rz[jlo - i]) * K10_LOG2E - li);
        st[n][2 + e] = exp2f((st[n][2 + e] * scale + gi * rz[jhi - i]) * K10_LOG2E - li);
      }
    uint32_t af[4][4];
    to_frags(st, af);
    mma_ab(dvt, af, Dt, lane);  // dV += P^T dO
    float dpt[8][4];
    mma_abt(dpt, vf, Dt, lane);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = rw[2 * K10_ROWS + 8 * n + c2 + e];
        st[n][e] *= dpt[n][e] - dl;
        st[n][2 + e] *= dpt[n][2 + e] - dl;
      }
    to_frags(st, af);
    mma_ab(dkt, af, Qt, lane);  // dK += dS^T Q
    __syncthreads();
  }
  // each warp read only its own rows of Ks and Vs
  store_rows(dk + base, ld, Ks, dkt, scale, scale, warp * 16, j0, L, lane);
  store_rows(dv + base, ld, Vs, dvt, 1.0f, 1.0f, warp * 16, j0, L, lane);
}

__global__ void __launch_bounds__(K10_THREADS)
    k10_relpos_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const float* __restrict__ gate, const float* __restrict__ r, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
                      float* __restrict__ dg, float* __restrict__ part, int L, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;  // the CTA's query rows, then dQ
  unsigned char* Ds = smem + K10_TILE;  // their dO rows
  unsigned char* KV = smem + 2 * K10_TILE;  // two buffers of a K and a V tile
  float* diag = reinterpret_cast<float*>(smem + 6 * K10_TILE);  // [64][DIAG_LD]: g_i dS_ij of a tile
  float* rs = diag + K10_ROWS * DIAG_LD;
  float* ps = rs + k10_r_floats(L);  // the CTA's partial dr row: column u holds offset u - (i0 + 63)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c2 = 2 * (lane & 3);
  const int bh = blockIdx.x, b = bh / H, h = bh % H, i0 = blockIdx.y * K10_ROWS, nk = k10_tiles(L);
  const int W = k10_part_width(L);
  const long ld = (long)H * DH, base = (long)b * L * ld + (long)h * DH;

  k10_load_tile(Qs, q + base, ld, i0, L, tid);
  k10_load_tile(Ds, dout + base, ld, i0, L, tid);
  k10_load_tile(KV, k + base, ld, 0, L, tid);
  k10_load_tile(KV + K10_TILE, v + base, ld, 0, L, tid);
  cp_async_commit();
  const float* rz = stage_r(rs, r + (long)h * (2 * L - 1), L, tid);
  for (int u = tid; u < W; u += K10_THREADS) ps[u] = 0.0f;
  const int rlo = warp * 16 + g, ilo = i0 + rlo, ihi = ilo + 8;  // this lane's rows
  const long at_lo = (long)bh * L + ilo, at_hi = at_lo + 8;
  const bool ok_lo = ilo < L, ok_hi = ihi < L;
  const float glo = ok_lo ? gate[at_lo] : 0.0f, ghi = ok_hi ? gate[at_hi] : 0.0f;
  const float llo = ok_lo ? lse[at_lo] * K10_LOG2E : INFINITY, lhi = ok_hi ? lse[at_hi] * K10_LOG2E : INFINITY;
  const float dlo = ok_lo ? delta[at_lo] : 0.0f, dhi = ok_hi ? delta[at_hi] : 0.0f;

  float dqt[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dqt[n][0] = dqt[n][1] = dqt[n][2] = dqt[n][3] = 0.0f;
  float dg_lo = 0.0f, dg_hi = 0.0f;
  uint32_t qf[4][4], df[4][4];
  for (int t = 0; t < nk; ++t) {
    const unsigned char* Kt = KV + (t & 1) * 2 * K10_TILE;
    const unsigned char* Vt = Kt + K10_TILE;
    if (t + 1 < nk) {
      unsigned char* nxt = KV + ((t + 1) & 1) * 2 * K10_TILE;
      k10_load_tile(nxt, k + base, ld, (t + 1) * K10_ROWS, L, tid);
      k10_load_tile(nxt + K10_TILE, v + base, ld, (t + 1) * K10_ROWS, L, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        frag_a(Qs, warp * 16, kk, lane, qf[kk]);
        frag_a(Ds, warp * 16, kk, lane, df[kk]);
      }
    const int j0 = t * K10_ROWS;
    float s[8][4], dp[8][4];
    mma_abt(s, qf, Kt, lane);
    mma_abt(dp, df, Vt, lane);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + c2 + e, j = j0 + c;
        const float r_lo = rz[j - ilo], r_hi = rz[j - ihi];
        const float p_lo = j < L ? exp2f((s[n][e] * scale + glo * r_lo) * K10_LOG2E - llo) : 0.0f;
        const float p_hi = j < L ? exp2f((s[n][2 + e] * scale + ghi * r_hi) * K10_LOG2E - lhi) : 0.0f;
        s[n][e] = p_lo * (dp[n][e] - dlo);  // dS
        s[n][2 + e] = p_hi * (dp[n][2 + e] - dhi);
        dg_lo += s[n][e] * r_lo;
        dg_hi += s[n][2 + e] * r_hi;
      }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(diag + rlo * DIAG_LD + 8 * n + c2) = make_float2(glo * s[n][0], glo * s[n][1]);
      *reinterpret_cast<float2*>(diag + (rlo + 8) * DIAG_LD + 8 * n + c2) =
          make_float2(ghi * s[n][2], ghi * s[n][3]);
    }
    uint32_t sf[4][4];
    to_frags(s, sf);
    mma_ab(dqt, sf, Kt, lane);  // dQ += dS K
    __syncthreads();  // the scratch tile is whole
    if (tid < 2 * K10_ROWS - 1) {  // diagonal e: column - row = e - 63, offset j0 - i0 + e - 63, column j0 + e
      float sum = 0.0f;
      for (int rr = 0; rr < K10_ROWS; ++rr) {
        const int cc = rr + tid - (K10_ROWS - 1);
        if (cc >= 0 && cc < K10_ROWS) sum += diag[rr * DIAG_LD + cc];
      }
      if (j0 + tid < W) ps[j0 + tid] += sum;
    }
    __syncthreads();  // the scratch tile and this K, V buffer are free
  }
  store_rows(dq + base, ld, Qs, dqt, scale, scale, warp * 16, i0, L, lane);
  dg_lo = quad_sum(dg_lo);
  dg_hi = quad_sum(dg_hi);
  if ((lane & 3) == 0) {
    if (ok_lo) dg[at_lo] = dg_lo;
    if (ok_hi) dg[at_hi] = dg_hi;
  }
  float* prow = part + ((long)bh * gridDim.y + blockIdx.y) * W;
  for (int u = tid; u < W; u += K10_THREADS) prow[u] = ps[u];
}

// dr[h, c] (offset c - L + 1) = the partial rows' sums over entries, then
// query tiles; query tile t's row holds offset d at column d + t 64 + 63
__global__ void __launch_bounds__(256) k10_relpos_bwd_dr(const float* __restrict__ part, float* __restrict__ dr,
                                                         int B, int L, int H) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, h = blockIdx.y, nq = k10_tiles(L), W = k10_part_width(L);
  if (c >= 2 * L - 1) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b)
    for (int t = 0; t < nq; ++t) {
      const int u = c - L + K10_ROWS + t * K10_ROWS;
      if (u >= 0 && u < W) s += part[(((long)b * H + h) * nq + t) * W + u];
    }
  dr[(long)h * (2 * L - 1) + c] = s;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

bool k10_shapes_ok(int B, int L, int H) { return B >= 1 && H >= 1 && L >= 1 && L <= K10_MAX_L; }

}  // namespace

// The launch facts of K10 at (B, L, H), as ops/kernels/relpos_attn.py::
// relpos_plan gives them: plan[0..6] = query (or key) tiles a head, the
// forward's, dkdv's and dq's shared memory a CTA, the floats of the
// backward's partial dr rows, the longest L, threads a CTA. Returns
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int msmd_relpos_plan(int B, int L, int H, long* plan) {
  if (!k10_shapes_ok(B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  const long out[7] = {k10_tiles(L), (long)fwd_smem(L), (long)dkdv_smem(L), (long)dq_smem(L),
                       (long)B * H * k10_tiles(L) * k10_part_width(L), K10_MAX_L, K10_THREADS};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
  return 0;
}

// out (B, L, H, 64) bf16 and lse (B, H, L) f32 from contiguous q, k, v
// (B, L, H, 64) bf16, g (B, H, L) and r (H, 2L - 1) f32, 1 <= L <= 2048.
// Launches on `stream`; returns the first CUDA error or 0.
extern "C" int msmd_relpos_forward(const bf16* q, const bf16* k, const bf16* v, const float* g, const float* r,
                                   bf16* out, float* lse, int B, int L, int H, cudaStream_t st) {
  if (!k10_shapes_ok(B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;  // the shared-memory limit above 48 KB, raised once for the longest L
  if (!ready) {
    RETURN_IF_ERROR(allow_smem(k10_relpos_fwd, fwd_smem(K10_MAX_L)));
    ready = true;
  }
  k10_relpos_fwd<<<dim3(B * H, k10_tiles(L)), K10_THREADS, fwd_smem(L), st>>>(q, k, v, g, r, out, lse, L, H,
                                                                               0.125f);
  return static_cast<int>(cudaGetLastError());
}

// K10's backward from the forward's out and lse and the cotangent dout
// (B, L, H, 64) bf16: dq, dk, dv (B, L, H, 64) bf16, dg (B, H, L) and dr
// (H, 2L - 1) f32. delta (B, H, L) and part (plan[4] floats) are the
// caller's scratch. Four launches on `stream`; returns the first CUDA
// error or 0.
extern "C" int msmd_relpos_backward(const bf16* q, const bf16* k, const bf16* v, const float* g, const float* r,
                                    const bf16* out, const float* lse, const bf16* dout, float* delta, float* part,
                                    bf16* dq, bf16* dk, bf16* dv, float* dg, float* dr, int B, int L, int H,
                                    cudaStream_t st) {
  if (!k10_shapes_ok(B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;
  if (!ready) {
    RETURN_IF_ERROR(allow_smem(k10_relpos_bwd_dkdv, dkdv_smem(K10_MAX_L)));
    RETURN_IF_ERROR(allow_smem(k10_relpos_bwd_dq, dq_smem(K10_MAX_L)));
    ready = true;
  }
  const long rows = (long)B * L * H;
  k10_relpos_bwd_pre<<<static_cast<unsigned>((rows * 8 + 255) / 256), 256, 0, st>>>(out, dout, delta, rows, L, H);
  RETURN_IF_ERROR(cudaGetLastError());
  const dim3 grid(B * H, k10_tiles(L));
  k10_relpos_bwd_dkdv<<<grid, K10_THREADS, dkdv_smem(L), st>>>(q, k, v, g, r, dout, lse, delta, dk, dv, L, H,
                                                                0.125f);
  RETURN_IF_ERROR(cudaGetLastError());
  k10_relpos_bwd_dq<<<grid, K10_THREADS, dq_smem(L), st>>>(q, k, v, g, r, dout, lse, delta, dq, dg, part, L, H,
                                                            0.125f);
  RETURN_IF_ERROR(cudaGetLastError());
  k10_relpos_bwd_dr<<<dim3((2 * L - 1 + 255) / 256, H), 256, 0, st>>>(part, dr, B, L, H);
  return static_cast<int>(cudaGetLastError());
}
