// K7: the training FFN block of a post-LN decoder layer, forward and
// backward, with in-kernel dropout masks:
//
//   out = LN(x + drop2(drop1(gelu(x W1 + b1)) W2 + b2))
//
// Replaces msmd_tpu/ops/pallas/ffn_train_kernel.py::fused_ffn_ln_train
// (forward _fwd_call, backward _bwd_call). Rounding follows that kernel
// (:107-219): every product rounds its left operand to bf16 and sums in
// f32; biases are added in f32; GELU is the erf form through the
// Abramowitz & Stegun 7.1.26 erf of decoder_kernel.py::_erf; the residual
// and the LayerNorm are f32; out and dx are bf16, the weight gradients
// are rounded to bf16 once, after the whole row sum.
//
// Weights come in the nn.Linear layout: w1 (FFN, F), w2 (F, FFN), so
// x W1 = x w1^T. Each route reads every operand as it lies, transposed
// where a product needs it.
//
// Dropout masks: bits = Philox4x32-10(key = (seed, salt), counter =
// (col / 4, row, 0, 0))[col % 4], keep = bits >= thr, scaled by 1/(1-p);
// salt 1 masks the hidden state, salt 2 the FFN output. The seed is read
// from device memory, so no host sync is needed to draw it. The backward
// regenerates the masks from (seed, row, col): no mask is stored between
// the two passes. ops/kernels/ffn_train.py holds the same generator in
// plain PyTorch, bit for bit.
//
// Bounds on an H100 SXM at rows 1776, F 512, FFN 2048: the forward's two
// products are 7.45 GFLOP (7.5 us at 989 TFLOP/s), the backward's six
// 22.3 GFLOP (22.6 us); both are bound by operations.
//
// Two routes, chosen by shape (never by failure):
// - Hopper (ffn_wgmma_ok: >= 1024 rows, F = 512, FFN in whole 256-column
//   tiles): the warp-specialized wgmma GEMM of gemm_train.cuh with the
//   masks, the residual, the LayerNorm and its backward in the epilogues.
//   The forward is two launches (FFN1 into the bf16 hidden state h, FFN2
//   with the LayerNorm), the backward six: FFN1 again (h, and m1 gelu'(u)
//   in f32), FFN2 again with the LayerNorm backward (dr, dy and the column
//   partials of db2, dg, db), dh = dy w2 (du, db1's partials), dx = dr +
//   du w1, dW1 = du^T x and dW2 = dy^T h in one grouped launch, and one
//   pass that sums the column partials in a fixed order (ffn_reduce_kernel).
//   Every sum has one order, so two calls give the same bits.
// - Every other shape: the first version's chain of 3 (forward) and 15
//   (backward) launches on a wmma tile over a cp.async ring with fused
//   epilogues, a LayerNorm kernel and column sums in two passes.

#include <type_traits>

#include "decoder_common.cuh"
#include "gemm_train.cuh"

namespace {

// multipliers (0 or scale) of 8 consecutive columns c0 .. c0 + 7, c0 % 8 == 0
__device__ __forceinline__ void mask8(const Dropout& d, uint32_t salt, int row, int c0, float m[8]) {
  if (d.thr == 0u) {
#pragma unroll
    for (int t = 0; t < 8; ++t) m[t] = 1.0f;
    return;
  }
  const uint32_t seed = static_cast<uint32_t>(*d.seed);
  const uint4 a = mask_bits4(seed, salt, row, c0 / 4), b = mask_bits4(seed, salt, row, c0 / 4 + 1);
  const uint32_t bits[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int t = 0; t < 8; ++t) m[t] = bits[t] >= d.thr ? d.scale : 0.0f;
}

// the multiplier (0 or scale) of column c of `row`
__device__ __forceinline__ float mask1(const Dropout& d, uint32_t salt, int row, int c) {
  if (d.thr == 0u) return 1.0f;
  const uint4 v = mask_bits4(static_cast<uint32_t>(*d.seed), salt, row, c / 4);
  const uint32_t bits[4] = {v.x, v.y, v.z, v.w};
  return bits[c % 4] >= d.thr ? d.scale : 0.0f;
}

// --------------------------------------------------------------------------
// the derivative of the erf GELU (gelu_erf and erf_as: decoder_common.cuh)
// --------------------------------------------------------------------------

__device__ __forceinline__ float gelu_erf_grad(float u) {
  const float phi = 0.3989422804014327f * expf(-0.5f * u * u);
  const float Phi = 0.5f * (1.0f + erf_as(u * 0.70710677f));
  return Phi + u * phi;
}

// --------------------------------------------------------------------------
// GEMM: C[M, N] = op(A)[M, K] @ op(B)[K, N], bf16 in, f32 accumulation.
// AT: A is stored (K, M) row-major; BT: B is stored (N, K) row-major.
// Rows of a stored operand along K may be ragged (zero-filled past K); a
// K along the columns of a stored operand needs K % 8 == 0. N % 128 == 0;
// M is ragged for a plain A and a multiple of BM for a transposed one.
// --------------------------------------------------------------------------

// E_HIDDEN: u = acc + b1; hb = bf16(gelu(u) * m1); gp = m1 * gelu'(u) (if set)
// E_OUT:    r = f32(x) + (acc + b2) * m2 (f32)
// E_DU:     du = acc * gp, written over gp (f32), and dub = bf16(du)
// E_DX:     dx = bf16(dr + acc)
// E_BF16:   C = bf16(acc)
enum { E_HIDDEN = 0, E_OUT = 1, E_DU = 2, E_DX = 3, E_BF16 = 4 };

struct Gemm {
  const bf16* A;
  long lda;
  const bf16* B;
  long ldb;
  int M, N, K;
  const bf16* bias;  // E_HIDDEN, E_OUT
  const bf16* xres;  // E_OUT: the bf16 residual x (M, N)
  const float* fres; // E_DX: dr (M, N)
  float* f32out;     // E_HIDDEN: gp (optional); E_OUT: r; E_DU: du (in place over gp)
  bf16* bout;        // E_HIDDEN: hb; E_DU: dub; E_DX: dx; E_BF16: C
  Dropout drop;
};

constexpr int G_LD_PAD = 8;

template <bool AT, int BM>
__host__ __device__ constexpr int a_tile_elems() { return AT ? BK * (BM + G_LD_PAD) : BM * (BK + G_LD_PAD); }
template <bool BT>
__host__ __device__ constexpr int b_tile_elems() { return BT ? BN * (BK + G_LD_PAD) : BK * (BN + G_LD_PAD); }

template <bool AT, bool BT, int BM>
constexpr size_t tgemm_smem_bytes() {
  return (size_t)STAGES * (a_tile_elems<AT, BM>() + b_tile_elems<BT>()) * sizeof(bf16) +
         (GEMM_THREADS / 32) * 16 * C_LD * sizeof(float);
}

template <bool AT, bool BT, int EPI, int BM>
__global__ void __launch_bounds__(GEMM_THREADS) tgemm_kernel(Gemm g) {
  constexpr int MI = BM / 32;  // 16-row fragments per warp
  constexpr int A_ELEMS = a_tile_elems<AT, BM>(), B_ELEMS = b_tile_elems<BT>();
  constexpr int LDA_S = AT ? BM + G_LD_PAD : BK + G_LD_PAD;
  constexpr int LDB_S = BT ? BK + G_LD_PAD : BN + G_LD_PAD;
  using ALayout = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;

  extern __shared__ __align__(128) unsigned char gsm[];
  bf16* As = reinterpret_cast<bf16*>(gsm);
  bf16* Bs = As + STAGES * A_ELEMS;
  float* Cs = reinterpret_cast<float*>(Bs + STAGES * B_ELEMS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int k0) {
    bf16* as = As + stage * A_ELEMS;
    bf16* bs = Bs + stage * B_ELEMS;
    if (AT) {  // BK rows of k, BM columns of m
      for (int i = tid; i < BK * (BM / 8); i += GEMM_THREADS) {
        const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
        const bool ok = k0 + r < g.K && m0 + c < g.M;
        cp_async16(as + r * LDA_S + c, ok ? g.A + (long)(k0 + r) * g.lda + m0 + c : g.A, ok);
      }
    } else {  // BM rows of m, BK columns of k
      for (int i = tid; i < BM * (BK / 8); i += GEMM_THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const bool ok = m0 + r < g.M && k0 + c < g.K;
        cp_async16(as + r * LDA_S + c, ok ? g.A + (long)(m0 + r) * g.lda + k0 + c : g.A, ok);
      }
    }
    if (BT) {  // BN rows of n, BK columns of k
      for (int i = tid; i < BN * (BK / 8); i += GEMM_THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const bool ok = n0 + r < g.N && k0 + c < g.K;
        cp_async16(bs + r * LDB_S + c, ok ? g.B + (long)(n0 + r) * g.ldb + k0 + c : g.B, ok);
      }
    } else {  // BK rows of k, BN columns of n
      for (int i = tid; i < BK * (BN / 8); i += GEMM_THREADS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const bool ok = k0 + r < g.K && n0 + c < g.N;
        cp_async16(bs + r * LDB_S + c, ok ? g.B + (long)(k0 + r) * g.ldb + n0 + c : g.B, ok);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = (g.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load_tile((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * A_ELEMS;
    const bf16* bs = Bs + (kt % STAGES) * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a[MI];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int mr = wm * (BM / 2) + i * 16;
        wmma::load_matrix_sync(a[i], AT ? as + kk * LDA_S + mr : as + mr * LDA_S + kk, LDA_S);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nc = wn * 32 + j * 16;
        wmma::load_matrix_sync(b[j], BT ? bs + nc * LDB_S + kk : bs + kk * LDB_S + nc, LDB_S);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: each fragment goes through the warp's 16 x 16 staging tile;
  // lane (r, half) then owns 8 consecutive columns of row r
  float* cs = Cs + warp * 16 * C_LD;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], C_LD, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * (BM / 2) + i * 16 + r;
      const int gc = n0 + wn * 32 + j * 16 + c0;
      if (gr < g.M) {
        float v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = cs[r * C_LD + c0 + t];
        const long o = (long)gr * g.N + gc;
        if (EPI == E_HIDDEN || EPI == E_OUT) {
          const uint4 ub = *reinterpret_cast<const uint4*>(g.bias + gc);
          const bf16* b8 = reinterpret_cast<const bf16*>(&ub);
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] += __bfloat162float(b8[t]);
        }
        if (EPI == E_HIDDEN) {
          float m[8];
          mask8(g.drop, 1u, gr, gc, m);
          uint4 packed;
          bf16* p8 = reinterpret_cast<bf16*>(&packed);
#pragma unroll
          for (int t = 0; t < 8; ++t) p8[t] = __float2bfloat16(gelu_erf(v[t]) * m[t]);
          *reinterpret_cast<uint4*>(g.bout + o) = packed;
          if (g.f32out) {
#pragma unroll
            for (int t = 0; t < 8; ++t) g.f32out[o + t] = m[t] * gelu_erf_grad(v[t]);
          }
        } else if (EPI == E_OUT) {
          float m[8];
          mask8(g.drop, 2u, gr, gc, m);
          const uint4 ux = *reinterpret_cast<const uint4*>(g.xres + o);
          const bf16* x8 = reinterpret_cast<const bf16*>(&ux);
#pragma unroll
          for (int t = 0; t < 8; ++t) g.f32out[o + t] = __bfloat162float(x8[t]) + v[t] * m[t];
        } else if (EPI == E_DU) {
          uint4 packed;
          bf16* p8 = reinterpret_cast<bf16*>(&packed);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float du = v[t] * g.f32out[o + t];
            g.f32out[o + t] = du;
            p8[t] = __float2bfloat16(du);
          }
          *reinterpret_cast<uint4*>(g.bout + o) = packed;
        } else {
          uint4 packed;
          bf16* p8 = reinterpret_cast<bf16*>(&packed);
#pragma unroll
          for (int t = 0; t < 8; ++t) p8[t] = __float2bfloat16(EPI == E_DX ? g.fres[o + t] + v[t] : v[t]);
          *reinterpret_cast<uint4*>(g.bout + o) = packed;
        }
      }
      __syncwarp();
    }
  }
}

template <bool AT, bool BT, int EPI, int BM>
cudaError_t tgemm_launch(cudaStream_t st, const Gemm& g) {
  static bool attr_set = false;
  if (!attr_set) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(tgemm_kernel<AT, BT, EPI, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(tgemm_smem_bytes<AT, BT, BM>())));
    attr_set = true;
  }
  tgemm_kernel<AT, BT, EPI, BM><<<dim3(g.N / BN, (g.M + BM - 1) / BM), GEMM_THREADS,
                                   tgemm_smem_bytes<AT, BT, BM>(), st>>>(g);
  return cudaGetLastError();
}

// BM 128 for the wide products over rows (N = FFN), 64 for the rest, so
// that the N = F products and the weight gradients fill the SMs
template <bool AT, bool BT, int EPI>
cudaError_t tgemm(cudaStream_t st, const Gemm& g) {
  if (!AT && g.N > 512) return tgemm_launch<AT, BT, EPI, 128>(st, g);
  return tgemm_launch<AT, BT, EPI, 64>(st, g);
}

// --------------------------------------------------------------------------
// LayerNorm forward and backward, one warp per row (F <= 1024, F % 32 == 0)
// --------------------------------------------------------------------------

constexpr int ROW_THREADS = 256, ROW_MAXN = 32;

__global__ void __launch_bounds__(ROW_THREADS) ln_fwd_kernel(const float* __restrict__ r, const float* __restrict__ gam,
                                                             const float* __restrict__ bet, bf16* __restrict__ out,
                                                             int R, int F) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  const int n = F / 32;
  const long base = (long)row * F;
  float v[ROW_MAXN];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < ROW_MAXN; ++i)
    if (i < n) {
      v[i] = r[base + lane + 32 * i];
      sum += v[i];
    }
  const float mu = warp_sum(sum) / F;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < ROW_MAXN; ++i)
    if (i < n) sq += (v[i] - mu) * (v[i] - mu);
  const float rs = rsqrtf(warp_sum(sq) / F + 1e-5f);
#pragma unroll
  for (int i = 0; i < ROW_MAXN; ++i)
    if (i < n) {
      const int c = lane + 32 * i;
      out[base + c] = __float2bfloat16((v[i] - mu) * rs * gam[c] + bet[c]);
    }
}

// From r = x + y and the incoming gradient gbar: dr (f32), dy = dr * m2
// (f32 for db2 and bf16 for the products), and gbar * yhat (f32, for dg).
__global__ void __launch_bounds__(ROW_THREADS) ln_bwd_kernel(const float* __restrict__ r, const bf16* __restrict__ gbar,
                                                             const float* __restrict__ gam, Dropout drop,
                                                             float* __restrict__ dr, float* __restrict__ dyf,
                                                             bf16* __restrict__ dyb, float* __restrict__ gy, int R,
                                                             int F) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  const int n = F / 32;
  const long base = (long)row * F;
  float v[ROW_MAXN], d[ROW_MAXN];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < ROW_MAXN; ++i)
    if (i < n) {
      v[i] = r[base + lane + 32 * i];
      sum += v[i];
    }
  const float mu = warp_sum(sum) / F;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < ROW_MAXN; ++i)
    if (i < n) sq += (v[i] - mu) * (v[i] - mu);
  const float rs = rsqrtf(warp_sum(sq) / F + 1e-5f);
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < ROW_MAXN; ++i)
    if (i < n) {
      const int c = lane + 32 * i;
      const float gb = __bfloat162float(gbar[base + c]);
      v[i] = (v[i] - mu) * rs;  // yhat
      d[i] = gb * gam[c];       // d yhat
      gy[base + c] = gb * v[i];
      s1 += d[i];
      s2 += d[i] * v[i];
    }
  const float m1 = warp_sum(s1) / F, m2 = warp_sum(s2) / F;
#pragma unroll
  for (int i = 0; i < ROW_MAXN; ++i)
    if (i < n) {
      const int c = lane + 32 * i;
      const float g = rs * (d[i] - m1 - v[i] * m2);
      const float y = g * mask1(drop, 2u, row, c);
      dr[base + c] = g;
      dyf[base + c] = y;
      dyb[base + c] = __float2bfloat16(y);
    }
}

// --------------------------------------------------------------------------
// column sums over rows, in two passes with a fixed order (deterministic)
// --------------------------------------------------------------------------

constexpr int COL_THREADS = 128, COL_CHUNKS = 16;

template <typename T>
__global__ void colsum_partial_kernel(const T* __restrict__ in, float* __restrict__ part, int R, int N, int chunk) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, s = blockIdx.y;
  if (c >= N) return;
  const int r1 = min(R, (s + 1) * chunk);
  float acc = 0.0f;
  for (int r = s * chunk; r < r1; ++r) acc += to_f32(in[(long)r * N + c]);
  part[(long)s * N + c] = acc;
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename O>
__global__ void colsum_final_kernel(const float* __restrict__ part, O* __restrict__ out, int N) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  float acc = 0.0f;
  for (int s = 0; s < COL_CHUNKS; ++s) acc += part[(long)s * N + c];
  store_as(out + c, acc);
}

template <typename T, typename O>
cudaError_t colsum(cudaStream_t st, const T* in, float* part, O* out, int R, int N) {
  const int chunk = (R + COL_CHUNKS - 1) / COL_CHUNKS;
  const int blocks = (N + COL_THREADS - 1) / COL_THREADS;
  colsum_partial_kernel<T><<<dim3(blocks, COL_CHUNKS), COL_THREADS, 0, st>>>(in, part, R, N, chunk);
  RETURN_IF_ERROR(cudaGetLastError());
  colsum_final_kernel<O><<<blocks, COL_THREADS, 0, st>>>(part, out, N);
  return cudaGetLastError();
}

__global__ void mask_bits_kernel(const int* seed, uint32_t salt, int R, int C, uint32_t* out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;  // one group of 4 columns
  const int groups = C / 4;
  if (i >= (long)R * groups) return;
  const int row = static_cast<int>(i / groups), g = static_cast<int>(i % groups);
  const uint4 b = mask_bits4(static_cast<uint32_t>(*seed), salt, row, g);
  uint32_t* o = out + (long)row * C + 4 * g;
  o[0] = b.x;
  o[1] = b.y;
  o[2] = b.z;
  o[3] = b.w;
}

// --------------------------------------------------------------------------
// workspace
// --------------------------------------------------------------------------

struct FfnWorkspace {
  bf16* hb;    // (R, FFN) bf16 hidden state
  float* gp;   // (R, FFN) m1 * gelu'(u), then du
  bf16* dub;   // (R, FFN) bf16 du
  float* r;    // (R, F) residual sum
  float* dr;   // (R, F)
  float* dyf;  // (R, F)
  bf16* dyb;   // (R, F)
  float* gy;   // (R, F) gbar * yhat
  float* part; // (COL_CHUNKS, FFN) column-sum partials
};

FfnWorkspace carve_ffn(void* ws, int R, int F, int FF, bool backward, size_t* total) {
  const size_t rf = (size_t)R * F, rff = (size_t)R * FF;
  const size_t sizes[9] = {rff * 2, backward ? rff * 4 : 0, backward ? rff * 2 : 0, rf * 4,
                           backward ? rf * 4 : 0, backward ? rf * 4 : 0, backward ? rf * 2 : 0,
                           backward ? rf * 4 : 0, backward ? (size_t)COL_CHUNKS * FF * 4 : 0};
  char* p = static_cast<char*>(ws);
  void* ptrs[9];
  size_t off = 0;
  for (int i = 0; i < 9; ++i) {
    ptrs[i] = p ? p + off : nullptr;
    off += align256(sizes[i]);
  }
  *total = off;
  return FfnWorkspace{(bf16*)ptrs[0], (float*)ptrs[1], (bf16*)ptrs[2], (float*)ptrs[3], (float*)ptrs[4],
                      (float*)ptrs[5], (bf16*)ptrs[6], (float*)ptrs[7], (float*)ptrs[8]};
}

bool ffn_shapes_ok(int R, int F, int FF) {
  return R > 0 && F % BN == 0 && FF % BN == 0 && F <= 32 * ROW_MAXN && F % 32 == 0;
}

// the forward chain to r = x + drop2(...) (two products); also gp when set
cudaError_t forward_to_residual(cudaStream_t st, const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                                const bf16* b2, const Dropout& drop, const FfnWorkspace& w, bool with_gp, int R,
                                int F, int FF) {
  Gemm g1{};
  g1.A = x; g1.lda = F; g1.B = w1; g1.ldb = F; g1.M = R; g1.N = FF; g1.K = F;
  g1.bias = b1; g1.bout = w.hb; g1.f32out = with_gp ? w.gp : nullptr; g1.drop = drop;
  RETURN_IF_ERROR((tgemm<false, true, E_HIDDEN>(st, g1)));
  Gemm g2{};
  g2.A = w.hb; g2.lda = FF; g2.B = w2; g2.ldb = FF; g2.M = R; g2.N = F; g2.K = FF;
  g2.bias = b2; g2.xres = x; g2.f32out = w.r; g2.drop = drop;
  return tgemm<false, true, E_OUT>(st, g2);
}

cudaError_t forward_wmma(cudaStream_t st, const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                         const bf16* b2, const float* gam, const float* bet, const Dropout& drop, bf16* out, void* ws,
                         int R, int F, int FF) {
  size_t total = 0;
  const FfnWorkspace w = carve_ffn(ws, R, F, FF, false, &total);
  RETURN_IF_ERROR(forward_to_residual(st, x, w1, b1, w2, b2, drop, w, false, R, F, FF));
  ln_fwd_kernel<<<(R * 32 + ROW_THREADS - 1) / ROW_THREADS, ROW_THREADS, 0, st>>>(w.r, gam, bet, out, R, F);
  return cudaGetLastError();
}

cudaError_t backward_wmma(cudaStream_t st, const bf16* x, const bf16* gbar, const bf16* w1, const bf16* b1,
                          const bf16* w2, const bf16* b2, const float* gam, const Dropout& drop, bf16* dx, bf16* dw1,
                          bf16* db1, bf16* dw2, bf16* db2, float* dg, float* db, void* ws, int R, int F, int FF) {
  size_t total = 0;
  const FfnWorkspace w = carve_ffn(ws, R, F, FF, true, &total);
  RETURN_IF_ERROR(forward_to_residual(st, x, w1, b1, w2, b2, drop, w, true, R, F, FF));
  ln_bwd_kernel<<<(R * 32 + ROW_THREADS - 1) / ROW_THREADS, ROW_THREADS, 0, st>>>(w.r, gbar, gam, drop, w.dr, w.dyf,
                                                                                  w.dyb, w.gy, R, F);
  RETURN_IF_ERROR(cudaGetLastError());

  Gemm gh{};  // dh = dy w2 -> du = dh * m1 * gelu'(u)
  gh.A = w.dyb; gh.lda = F; gh.B = w2; gh.ldb = FF; gh.M = R; gh.N = FF; gh.K = F;
  gh.f32out = w.gp; gh.bout = w.dub;
  RETURN_IF_ERROR((tgemm<false, false, E_DU>(st, gh)));
  Gemm gx{};  // dx = dr + du w1
  gx.A = w.dub; gx.lda = FF; gx.B = w1; gx.ldb = F; gx.M = R; gx.N = F; gx.K = FF;
  gx.fres = w.dr; gx.bout = dx;
  RETURN_IF_ERROR((tgemm<false, false, E_DX>(st, gx)));
  Gemm gw1{};  // dw1 = du^T x, (FFN, F)
  gw1.A = w.dub; gw1.lda = FF; gw1.B = x; gw1.ldb = F; gw1.M = FF; gw1.N = F; gw1.K = R;
  gw1.bout = dw1;
  RETURN_IF_ERROR((tgemm<true, false, E_BF16>(st, gw1)));
  Gemm gw2{};  // dw2 = dy^T h, (F, FFN)
  gw2.A = w.dyb; gw2.lda = F; gw2.B = w.hb; gw2.ldb = FF; gw2.M = F; gw2.N = FF; gw2.K = R;
  gw2.bout = dw2;
  RETURN_IF_ERROR((tgemm<true, false, E_BF16>(st, gw2)));

  RETURN_IF_ERROR(colsum(st, w.gp, w.part, db1, R, FF));
  RETURN_IF_ERROR(colsum(st, w.dyf, w.part, db2, R, F));
  RETURN_IF_ERROR(colsum(st, w.gy, w.part, dg, R, F));
  return colsum(st, gbar, w.part, db, R, F);
}

// --------------------------------------------------------------------------
// the Hopper route (gemm_train.cuh)
// --------------------------------------------------------------------------

// The shapes it takes: enough rows, F the two 256-column halves of a
// LayerNorm cluster, FFN in whole 256-column tiles. Any row count from
// there on: TMA zero-fills past the last row.
bool ffn_wgmma_ok(int R, int F, int FF) { return R >= SM90_MIN_ROWS && F == 2 * WS_BN && FF > 0 && FF % WS_BN == 0; }

int row_blocks(int R) { return (R + WS_BM - 1) / WS_BM; }

// The weight gradients' tiles: (FFN / 128) (F / 256) of dW1 and (F / 128)
// (FFN / 256) of dW2, each a cluster of two K-slices.
int wgrad_tiles(int F, int FF) { return 2 * (FF / WS_BM) * (F / WS_BN); }

constexpr int RED_THREADS = 256;
// the reduction pass: blocks of 32 columns of db1, db2, dg and db (F, FFN
// multiples of 32)
int reduce_grid(int F, int FF) { return (FF + 3 * F) / 32; }

struct TrainWs {
  bf16* h;     // (R, FFN) bf16 hidden state
  float* gp;   // (R, FFN) m1 gelu'(u)
  bf16* du;    // (R, FFN) bf16 du
  float* dr;   // (R, F)
  bf16* dy;    // (R, F) bf16 dy
  float* cp2;  // (3, 16 row blocks, F) column partials of dy, gbar yhat, gbar (a warp's 8 rows each)
  float* cp1;  // (8 row blocks, FFN) column partials of du (a warp's 16 rows each)
};

TrainWs carve_train(void* ws, int R, int F, int FF, bool backward, size_t* total) {
  const size_t rf = (size_t)R * F, rff = (size_t)R * FF, rb = row_blocks(R);
  const size_t b = backward ? 1 : 0;
  const size_t sizes[7] = {rff * 2, b * rff * 4, b * rff * 2, b * rf * 4, b * rf * 2, b * 3 * 16 * rb * F * 4,
                           b * 8 * rb * FF * 4};
  char* p = static_cast<char*>(ws);
  void* ptrs[7];
  size_t off = 0;
  for (int i = 0; i < 7; ++i) {
    ptrs[i] = p ? p + off : nullptr;
    off += align256(sizes[i]);
  }
  *total = off;
  return TrainWs{(bf16*)ptrs[0], (float*)ptrs[1], (bf16*)ptrs[2], (float*)ptrs[3],
                 (bf16*)ptrs[4], (float*)ptrs[5], (float*)ptrs[6]};
}

TrainProblem problem(int M, int N, int K, const Dropout& drop) {
  TrainProblem p{};
  p.M = M;
  p.N = N;
  p.K = K;
  p.drop = drop;
  return p;
}

struct ReduceArgs {
  const float* cp1;
  const float* cp2;
  int rows1, rows2;  // the column partials' rows
  bf16* db1;
  bf16* db2;
  float* dg;
  float* db;
  int F, FF;
};

// The column partials summed in a fixed order: db1 over du's, db2, dg and
// db over theirs; 8 row groups of a block each sum every 8th row of a
// column, then the groups in order.
__global__ void __launch_bounds__(RED_THREADS) ffn_reduce_kernel(const ReduceArgs a) {
  __shared__ float red[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x % 32, grp = threadIdx.x / 32;
  // column col of db1 (0 .. FFN), then of db2, dg, db (F each); a block's 32
  // columns lie in one of them
  const int set = col < a.FF ? -1 : (col - a.FF) / a.F, c = set < 0 ? col : (col - a.FF) % a.F;
  const int rows = set < 0 ? a.rows1 : a.rows2, ld = set < 0 ? a.FF : a.F;
  const float* p = set < 0 ? a.cp1 + c : a.cp2 + (long)set * a.rows2 * a.F + c;
  float s = 0.0f;
  for (int r = grp; r < rows; r += 8) s += p[(long)r * ld];
  red[grp][threadIdx.x % 32] = s;
  __syncthreads();
  if (grp != 0) return;
  for (int g = 1; g < 8; ++g) s += red[g][threadIdx.x];
  if (set < 0) {
    a.db1[c] = __float2bfloat16(s);
  } else if (set == 0) {
    a.db2[c] = __float2bfloat16(s);
  } else if (set == 1) {
    a.dg[c] = s;
  } else {
    a.db[c] = s;
  }
}

// FFN1 (x w1^T, epilogue TR_H or TR_HG) into h (and gp)
template <int EPI>
cudaError_t hidden_wgmma(cudaStream_t st, const bf16* x, const bf16* w1, const bf16* b1, const Dropout& drop,
                         const TrainWs& w, int R, int F, int FF) {
  TrainMaps m{};
  RETURN_IF_ERROR(make_a_map(&m.a[0], x, F, R, F, WS_BM));
  RETURN_IF_ERROR(make_w_map(&m.b[0], w1, FF, F));
  TrainLaunch L{};
  L.p[0] = problem(R, FF, F, drop);
  L.p[0].bias = b1;
  L.p[0].out = w.h;
  L.p[0].fout = w.gp;
  return gemm_train<EPI>(st, m, L, row_blocks(R) * (FF / WS_BN));
}

// FFN2 (h w2^T) with the LayerNorm (TR_LN) or its backward (TR_LN_BWD)
template <int EPI>
cudaError_t residual_wgmma(cudaStream_t st, const bf16* x, const bf16* gbar, const bf16* w2, const bf16* b2,
                           const float* gam, const float* bet, const Dropout& drop, bf16* out, const TrainWs& w, int R,
                           int F, int FF) {
  TrainMaps m{};
  RETURN_IF_ERROR(make_a_map(&m.a[0], w.h, FF, R, FF, WS_BM));
  RETURN_IF_ERROR(make_w_map(&m.b[0], w2, F, FF));
  TrainLaunch L{};
  L.p[0] = problem(R, F, FF, drop);
  L.p[0].bias = b2;
  L.p[0].xres = x;
  L.p[0].gbar = gbar;
  L.p[0].gam = gam;
  L.p[0].bet = bet;
  L.p[0].out = out;
  L.p[0].fout = w.dr;
  L.p[0].colpart = w.cp2;
  L.p[0].colpart_rows = 16 * row_blocks(R);
  return gemm_train<EPI>(st, m, L, tr_cluster(EPI) * row_blocks(R));
}

cudaError_t forward_wgmma(cudaStream_t st, const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                          const bf16* b2, const float* gam, const float* bet, const Dropout& drop, bf16* out, void* ws,
                          int R, int F, int FF) {
  size_t total = 0;
  const TrainWs w = carve_train(ws, R, F, FF, false, &total);
  RETURN_IF_ERROR(hidden_wgmma<TR_H>(st, x, w1, b1, drop, w, R, F, FF));
  return residual_wgmma<TR_LN>(st, x, nullptr, w2, b2, gam, bet, drop, out, w, R, F, FF);
}

cudaError_t backward_wgmma(cudaStream_t st, const bf16* x, const bf16* gbar, const bf16* w1, const bf16* b1,
                           const bf16* w2, const bf16* b2, const float* gam, const Dropout& drop, bf16* dx, bf16* dw1,
                           bf16* db1, bf16* dw2, bf16* db2, float* dg, float* db, void* ws, int R, int F, int FF) {
  size_t total = 0;
  const TrainWs w = carve_train(ws, R, F, FF, true, &total);
  const Dropout none{drop.seed, 0u, 1.0f};  // the products past the masks
  const int rb = row_blocks(R);
  // the forward again: h and gp; then dr, dy and the column partials of
  // db2, dg and db
  RETURN_IF_ERROR(hidden_wgmma<TR_HG>(st, x, w1, b1, drop, w, R, F, FF));
  RETURN_IF_ERROR(residual_wgmma<TR_LN_BWD>(st, x, gbar, w2, b2, gam, nullptr, drop, w.dy, w, R, F, FF));
  {  // dh = dy w2 (w2 (F, FFN) read N-major): du = dh gp, db1's partials
    TrainMaps m{};
    RETURN_IF_ERROR(make_a_map(&m.a[0], w.dy, F, R, F, WS_BM));
    RETURN_IF_ERROR(make_b_map(&m.b[0], w2, F, FF, 1));
    TrainLaunch L{};
    L.p[0] = problem(R, FF, F, none);
    L.p[0].fin = w.gp;
    L.p[0].out = w.du;
    L.p[0].colpart = w.cp1;
    L.p[0].colpart_rows = 8 * rb;
    RETURN_IF_ERROR(gemm_train<TR_DU>(st, m, L, rb * (FF / WS_BN)));
  }
  {  // dx = dr + du w1 (w1 (FFN, F) read N-major), K split over the cluster
    TrainMaps m{};
    RETURN_IF_ERROR(make_a_map(&m.a[0], w.du, FF, R, FF, WS_BM));
    RETURN_IF_ERROR(make_b_map(&m.b[0], w1, FF, F, 1));
    TrainLaunch L{};
    L.p[0] = problem(R, F, FF, none);
    L.p[0].fin = w.dr;
    L.p[0].out = dx;
    RETURN_IF_ERROR(gemm_train<TR_DX>(st, m, L, tr_cluster(TR_DX) * rb));
  }
  {  // dW1 = du^T x and dW2 = dy^T h: A MN-major, B N-major, K = the rows
    TrainMaps m{};
    RETURN_IF_ERROR(make_b_map(&m.a[0], w.du, R, FF, 1));
    RETURN_IF_ERROR(make_b_map(&m.b[0], x, R, F, 1));
    RETURN_IF_ERROR(make_b_map(&m.a[1], w.dy, R, F, 1));
    RETURN_IF_ERROR(make_b_map(&m.b[1], w.h, R, FF, 1));
    TrainLaunch L{};
    L.p[0] = problem(FF, F, R, none);
    L.p[0].out = dw1;
    L.p[1] = problem(F, FF, R, none);
    L.p[1].out = dw2;
    L.blocks0 = tr_cluster(TR_WGRAD) * (FF / WS_BM) * (F / WS_BN);
    RETURN_IF_ERROR(gemm_train<TR_WGRAD>(st, m, L, tr_cluster(TR_WGRAD) * wgrad_tiles(F, FF)));
  }
  const ReduceArgs ra{w.cp1, w.cp2, 8 * rb, 16 * rb, db1, db2, dg, db, F, FF};
  ffn_reduce_kernel<<<reduce_grid(F, FF), RED_THREADS, 0, st>>>(ra);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t msmd_ffn_train_workspace_bytes(int R, int F, int FF, int backward) {
  size_t total = 0;
  if (ffn_wgmma_ok(R, F, FF)) {
    carve_train(nullptr, R, F, FF, backward != 0, &total);
  } else {
    carve_ffn(nullptr, R, F, FF, backward != 0, &total);
  }
  return total;
}

// What msmd_ffn_train_forward (backward = 0) or _backward runs at (R, F,
// FFN): out = {route (1 the Hopper GEMM, 0 the wmma chain), launches, the
// weight gradients' row chunks (0 where none), then on the Hopper route
// the grid of each launch in order (0 past the last)}; all -1 for a shape
// neither takes.
extern "C" void msmd_ffn_train_plan(int R, int F, int FF, int backward, long* out) {
  for (int i = 0; i < 9; ++i) out[i] = -1;
  if (!ffn_shapes_ok(R, F, FF)) return;
  for (int i = 2; i < 9; ++i) out[i] = 0;
  if (!ffn_wgmma_ok(R, F, FF)) {
    out[0] = 0;
    out[1] = backward ? 15 : 3;
    return;
  }
  const int rb = row_blocks(R), wide = rb * (FF / WS_BN), pairs = tr_cluster(TR_LN) * rb;
  out[0] = 1;
  if (!backward) {
    out[1] = 2;
    out[3] = wide;
    out[4] = pairs;
    return;
  }
  const int chunks = tr_cluster(TR_WGRAD);
  const long grids[6] = {wide, pairs, wide, pairs, (long)chunks * wgrad_tiles(F, FF), reduce_grid(F, FF)};
  out[1] = 6;
  out[2] = chunks;
  for (int i = 0; i < 6; ++i) out[3 + i] = grids[i];
}

// out (R, F) bf16 = LN(x + drop2(drop1(gelu(x w1^T + b1)) w2^T + b2))
extern "C" int msmd_ffn_train_forward(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                                      const float* gam, const float* bet, const int* seed, unsigned int thr,
                                      float scale, bf16* out, void* ws, int R, int F, int FF, cudaStream_t st) {
  if (!ffn_shapes_ok(R, F, FF)) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{seed, thr, scale};
  if (ffn_wgmma_ok(R, F, FF)) return static_cast<int>(forward_wgmma(st, x, w1, b1, w2, b2, gam, bet, drop, out, ws, R, F, FF));
  return static_cast<int>(forward_wmma(st, x, w1, b1, w2, b2, gam, bet, drop, out, ws, R, F, FF));
}

// Recomputes the forward from x with the same masks, then dx (R, F) bf16,
// dw1 (FFN, F) and dw2 (F, FFN) bf16, db1 (FFN) and db2 (F) bf16, dg and
// db (F) f32.
extern "C" int msmd_ffn_train_backward(const bf16* x, const bf16* gbar, const bf16* w1, const bf16* b1,
                                       const bf16* w2, const bf16* b2, const float* gam, const float* bet,
                                       const int* seed, unsigned int thr, float scale, bf16* dx, bf16* dw1,
                                       bf16* db1, bf16* dw2, bf16* db2, float* dg, float* db, void* ws, int R,
                                       int F, int FF, cudaStream_t st) {
  (void)bet;
  if (!ffn_shapes_ok(R, F, FF)) return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{seed, thr, scale};
  if (ffn_wgmma_ok(R, F, FF))
    return static_cast<int>(backward_wgmma(st, x, gbar, w1, b1, w2, b2, gam, drop, dx, dw1, db1, dw2, db2, dg, db,
                                           ws, R, F, FF));
  return static_cast<int>(backward_wmma(st, x, gbar, w1, b1, w2, b2, gam, drop, dx, dw1, db1, dw2, db2, dg, db, ws,
                                        R, F, FF));
}

// The raw Philox bits of the dropout masks, (R, C) uint32 (C % 4 == 0):
// a debug entry that checks the device generator against the plain one.
extern "C" int msmd_ffn_train_mask_bits(const int* seed, int salt, int R, int C, uint32_t* out, cudaStream_t st) {
  if (C % 4 != 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long n = (long)R * (C / 4);
  mask_bits_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(seed, static_cast<uint32_t>(salt), R, C,
                                                                          out);
  return static_cast<int>(cudaGetLastError());
}
