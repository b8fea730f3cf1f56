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
// Pallas grid.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// --------------------------------------------------------------------------
// common
// --------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// the bf16 "fast" softmax numerator: exp(clamp(s - 20, -80, 60))
__device__ __forceinline__ float fast_exp(float s) {
  return expf(fminf(fmaxf(s - 20.0f, -80.0f), 60.0f));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

constexpr int DH = 64;  // head dim the attention kernels are written for

// --------------------------------------------------------------------------
// GEMM: C[M, N] = A[M, K] @ B[K, N], bf16 in, f32 accumulation, fused epilogue
// --------------------------------------------------------------------------

// Block tile BM x 128 x 32, 8 warps as 2 x 4, each (BM / 2) x 32; a ring of
// STAGES tiles in shared memory, filled by cp.async STAGES - 1 tiles ahead.
// BM = 128 for the wide products (QKV, FFN1), BM = 64 for the N = 512 ones
// (self-out, FFN2, the person rows), which would leave most SMs idle at 128.
constexpr int BN = 128, BK = 32, PAD = 8, STAGES = 4, GEMM_THREADS = 256;
constexpr int A_LD = BK + PAD, B_LD = BN + PAD, C_LD = 16 + 4;

enum { EPI_BF16 = 0, EPI_RESID = 1, EPI_GELU = 2 };

struct GemmArgs {
  const bf16* A;
  long lda;
  const int* a_rows;  // optional: A row r is A[a_rows[r]]
  const bf16* B;      // K x N row-major (the JAX (in, out) layout)
  const bf16* bias;   // N, or null
  const float* res;   // M x N f32 residual (EPI_RESID)
  void* C;            // M x N: bf16 (EPI_BF16, EPI_GELU) or f32 (EPI_RESID)
  int M, N, K;
  float scale;     // EPI_BF16: columns < scale_cols are multiplied by scale
  int scale_cols;  // before the bf16 cast
};

template <int BM>
constexpr size_t gemm_smem_bytes() {
  return (size_t)STAGES * (BM * A_LD + BK * B_LD) * sizeof(bf16) + (GEMM_THREADS / 32) * 16 * C_LD * sizeof(float);
}

template <int EPI, int BM>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  constexpr int MI = BM / 32;  // 16-row fragments per warp
  extern __shared__ __align__(128) unsigned char gsm[];
  bf16* As = reinterpret_cast<bf16*>(gsm);            // [STAGES][BM][A_LD]
  bf16* Bs = As + STAGES * BM * A_LD;                 // [STAGES][BK][B_LD]
  float* Cs = reinterpret_cast<float*>(Bs + STAGES * BK * B_LD);  // [8 warps][16][C_LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int k0) {
    bf16* as = As + stage * BM * A_LD;
    bf16* bs = Bs + stage * BK * B_LD;
    for (int i = tid; i < BM * (BK / 8); i += GEMM_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8, gr = m0 + r;
      const bool ok = gr < g.M;
      const bf16* src = g.A;
      if (ok) src = g.A + (long)(g.a_rows ? g.a_rows[gr] : gr) * g.lda + k0 + c;
      cp_async16(as + r * A_LD + c, src, ok);
    }
    for (int i = tid; i < BK * (BN / 8); i += GEMM_THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      cp_async16(bs + r * B_LD + c, g.B + (long)(k0 + r) * g.N + n0 + c, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = g.K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s * BK);
    cp_async_commit();  // an empty group past the end keeps the wait count uniform
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread, and stage (kt - 1) is free
    if (kt + STAGES - 1 < KT) load_tile((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * BM * A_LD;
    const bf16* bs = Bs + (kt % STAGES) * BK * B_LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[MI];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < MI; ++i) wmma::load_matrix_sync(a[i], as + (wm * (BM / 2) + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], bs + kk * B_LD + wn * 32 + j * 16, B_LD);
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
        const float4 lo = *reinterpret_cast<const float4*>(cs + r * C_LD + c0);
        const float4 hi = *reinterpret_cast<const float4*>(cs + r * C_LD + c0 + 4);
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        if (g.bias) {
          const uint4 ub = *reinterpret_cast<const uint4*>(g.bias + gc);
          const bf16* b8 = reinterpret_cast<const bf16*>(&ub);
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] += __bfloat162float(b8[t]);
        }
        const long o = (long)gr * g.N + gc;
        if (EPI == EPI_RESID) {
          const float4 r0 = *reinterpret_cast<const float4*>(g.res + o);
          const float4 r1 = *reinterpret_cast<const float4*>(g.res + o + 4);
          float4* out = reinterpret_cast<float4*>(static_cast<float*>(g.C) + o);
          out[0] = make_float4(r0.x + v[0], r0.y + v[1], r0.z + v[2], r0.w + v[3]);
          out[1] = make_float4(r1.x + v[4], r1.y + v[5], r1.z + v[6], r1.w + v[7]);
        } else {
          uint4 packed;
          bf16* p8 = reinterpret_cast<bf16*>(&packed);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            float y = v[t];
            if (EPI == EPI_BF16 && gc + t < g.scale_cols) y *= g.scale;
            if (EPI == EPI_GELU) y = gelu_tanh(y);
            p8[t] = __float2bfloat16(y);
          }
          *reinterpret_cast<uint4*>(static_cast<bf16*>(g.C) + o) = packed;
        }
      }
      __syncwarp();
    }
  }
}

template <int EPI, int BM>
cudaError_t gemm_attr() {
  return cudaFuncSetAttribute(gemm_kernel<EPI, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(gemm_smem_bytes<BM>()));
}

template <int EPI>
cudaError_t gemm(cudaStream_t st, const bf16* A, long lda, const int* a_rows, const bf16* B,
                 const bf16* bias, const float* res, void* C, int M, int N, int K,
                 float scale = 1.0f, int scale_cols = 0) {
  GemmArgs g{A, lda, a_rows, B, bias, res, C, M, N, K, scale, scale_cols};
  if (N > 512) {
    gemm_kernel<EPI, 128><<<dim3(N / BN, (M + 127) / 128), GEMM_THREADS, gemm_smem_bytes<128>(), st>>>(g);
  } else {
    gemm_kernel<EPI, 64><<<dim3(N / BN, (M + 63) / 64), GEMM_THREADS, gemm_smem_bytes<64>(), st>>>(g);
  }
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// per-entry self-attention: one block per (head, entry)
// --------------------------------------------------------------------------

constexpr int ATT_THREADS = 256;
constexpr int QK_LD = DH + 8;  // bf16 row stride of Q, K, V in shared memory
constexpr int O_LD = DH + 4;   // f32 row stride of the PV output

__host__ __device__ inline int att_lp(int lq) { return (lq + 15) / 16 * 16; }
__host__ __device__ inline int att_s_cols(int lp) { return lp + 4 > O_LD ? lp + 4 : O_LD; }

// Q, K, V (bf16), then the f32 scores (later the PV output), then the row
// sums; the bf16 numerators P reuse the Q and K rows once S is taken
// (lp * (lp + 8) <= 2 * lp * QK_LD for lp <= 128).
inline size_t att_smem_bytes(int lq) {
  const int lp = att_lp(lq);
  return (size_t)3 * lp * QK_LD * 2 + (size_t)lp * att_s_cols(lp) * 4 + lp * 4;
}

// qkv: (Be*lq, 3F) bf16 with q already scaled; out: (Be*lq, F) bf16
__global__ void __launch_bounds__(ATT_THREADS) self_attn_kernel(const bf16* __restrict__ qkv,
                                                                bf16* __restrict__ out, int lq, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, e = blockIdx.y;
  const int nt = (lq + 15) / 16, lp = nt * 16;
  const int s_ld = lp + 4, p_ld = lp + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + lp * QK_LD;
  bf16* Vs = Ks + lp * QK_LD;
  float* Ss = reinterpret_cast<float*>(Vs + lp * QK_LD);  // scores, then the PV output
  float* rs = Ss + lp * att_s_cols(lp);
  bf16* Ps = Qs;  // written only after every warp has read Q and K

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long row0 = (long)e * lq, ld = 3L * F;

  for (int i = tid; i < lp * (DH / 8); i += ATT_THREADS) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q;
    if (r < lq) {
      const bf16* base = qkv + (row0 + r) * ld + h * DH + c;
      q = *reinterpret_cast<const uint4*>(base);
      k = *reinterpret_cast<const uint4*>(base + F);
      v = *reinterpret_cast<const uint4*>(base + 2 * F);
    }
    *reinterpret_cast<uint4*>(Qs + r * QK_LD + c) = q;
    *reinterpret_cast<uint4*>(Ks + r * QK_LD + c) = k;
    *reinterpret_cast<uint4*>(Vs + r * QK_LD + c) = v;
  }
  __syncthreads();

  // S = Q K^T (f32)
  for (int t = warp; t < nt * nt; t += ATT_THREADS / 32) {
    const int ti = t / nt, tj = t % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k = 0; k < DH; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Qs + ti * 16 * QK_LD + k, QK_LD);
      wmma::load_matrix_sync(b, Ks + tj * 16 * QK_LD + k, QK_LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Ss + ti * 16 * s_ld + tj * 16, acc, s_ld, wmma::mem_row_major);
  }
  __syncthreads();

  // unnormalised numerators (bf16 for the PV product) and f32 row sums
  for (int r = warp; r < lp; r += ATT_THREADS / 32) {
    float sum = 0.0f;
    for (int c = lane; c < lp; c += 32) {
      float p = 0.0f;
      if (r < lq && c < lq) {
        p = fast_exp(Ss[r * s_ld + c]);
        sum += p;
      }
      Ps[r * p_ld + c] = __float2bfloat16(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) rs[r] = sum;
  }
  __syncthreads();

  // O = P V (f32), written over the scores
  for (int t = warp; t < nt * (DH / 16); t += ATT_THREADS / 32) {
    const int ti = t / (DH / 16), tj = t % (DH / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < lp; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, Ps + ti * 16 * p_ld + k, p_ld);
      wmma::load_matrix_sync(b, Vs + k * QK_LD + tj * 16, QK_LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    __syncwarp();
    wmma::store_matrix_sync(Ss + ti * 16 * O_LD + tj * 16, acc, O_LD, wmma::mem_row_major);
  }
  __syncthreads();

  for (int i = tid; i < lq * DH; i += ATT_THREADS) {
    const int r = i / DH, c = i % DH;
    const float inv = 1.0f / rs[r];
    out[(row0 + r) * F + h * DH + c] = __float2bfloat16(Ss[r * O_LD + c] * inv);
  }
}

// --------------------------------------------------------------------------
// identity-band person-row cross-attention: block per entry, warp per head
// --------------------------------------------------------------------------

constexpr int MAX_LM = 128;

// qp: (Be, F) bf16, scaled; km, vm: (Be*lm, F) bf16; out: (Be, F) bf16
__global__ void person_attn_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ km,
                                   const bf16* __restrict__ vm, bf16* __restrict__ out, int lm, int F) {
  extern __shared__ float psm[];
  const int e = blockIdx.x, h = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = psm + h * (DH + MAX_LM);
  float* es = qs + DH;
  for (int d = lane; d < DH; d += 32) qs[d] = __bfloat162float(qp[(long)e * F + h * DH + d]);
  __syncwarp();

  float sum = 0.0f;
  for (int j = lane; j < lm; j += 32) {
    const bf16* krow = km + ((long)e * lm + j) * F + h * DH;
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < DH; d += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(krow + d);
      const bf16* kv = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int t = 0; t < 8; ++t) s += qs[d + t] * __bfloat162float(kv[t]);
    }
    const float p = fast_exp(s);
    es[j] = __bfloat162float(__float2bfloat16(p));
    sum += p;
  }
  sum = warp_sum(sum);
  __syncwarp();

  const float inv = 1.0f / sum;
  for (int d = lane; d < DH; d += 32) {
    float acc = 0.0f;
    for (int j = 0; j < lm; ++j) acc += es[j] * __bfloat162float(vm[((long)e * lm + j) * F + h * DH + d]);
    out[(long)e * F + h * DH + d] = __float2bfloat16(acc * inv);
  }
}

// --------------------------------------------------------------------------
// LayerNorm, one warp per row (F <= 1024); writes x (f32) and its bf16 copy
// --------------------------------------------------------------------------

constexpr int LN_THREADS = 256, LN_MAXN = 32;

// CROSS = false: y is the residual sum. CROSS = true: the row is
// x + ((person row ? po[e] : 0) + vmw + bco), the identity-band cross step.
template <bool CROSS>
__global__ void __launch_bounds__(LN_THREADS) ln_kernel(const float* y, float* x, bf16* xb,
                                                        const float* __restrict__ scale,
                                                        const float* __restrict__ bias, int R, int F,
                                                        const bf16* po, const bf16* vmw, const bf16* bco,
                                                        const int* aux, int lq) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  const int n = F / 32;
  const long base = (long)row * F;
  int pe = -1;
  if (CROSS) {
    const int e = row / lq;
    if (aux[e] == row) pe = e;
  }
  float v[LN_MAXN];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_MAXN; ++i) {
    if (i < n) {
      const int c = lane + 32 * i;
      float t;
      if (CROSS) {
        float ca = (pe >= 0 ? __bfloat162float(po[(long)pe * F + c]) : 0.0f) + __bfloat162float(vmw[base + c]);
        ca = ca + __bfloat162float(bco[c]);
        t = x[base + c] + ca;
      } else {
        t = y[base + c];
      }
      v[i] = t;
      sum += t;
    }
  }
  const float mu = warp_sum(sum) / F;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_MAXN; ++i)
    if (i < n) sq += (v[i] - mu) * (v[i] - mu);
  const float rstd = rsqrtf(warp_sum(sq) / F + 1e-5f);
#pragma unroll
  for (int i = 0; i < LN_MAXN; ++i) {
    if (i < n) {
      const int c = lane + 32 * i;
      const float o = (v[i] - mu) * rstd * scale[c] + bias[c];
      x[base + c] = o;
      xb[base + c] = __float2bfloat16(o);
    }
  }
}

__global__ void cast_kernel(const float* __restrict__ x_in, float* __restrict__ x, bf16* __restrict__ xb, long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n; i += (long)gridDim.x * blockDim.x) {
    const float v = x_in[i];
    x[i] = v;
    xb[i] = __float2bfloat16(v);
  }
}

inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

struct Workspace {
  bf16 *xb, *qkv, *sa, *h, *qp, *pa, *po;
  float* y;
};

Workspace carve(void* ws, int Be, int lq, int F, int FF, size_t* total) {
  const size_t R = (size_t)Be * lq;
  const size_t sizes[8] = {R * F * 2, R * 3 * F * 2, R * F * 2, R * FF * 2,
                           (size_t)Be * F * 2, (size_t)Be * F * 2, (size_t)Be * F * 2, R * F * 4};
  char* p = static_cast<char*>(ws);
  void* ptrs[8];
  size_t off = 0;
  for (int i = 0; i < 8; ++i) {
    ptrs[i] = p ? p + off : nullptr;
    off += align256(sizes[i]);
  }
  *total = off;
  return Workspace{(bf16*)ptrs[0], (bf16*)ptrs[1], (bf16*)ptrs[2], (bf16*)ptrs[3],
                   (bf16*)ptrs[4], (bf16*)ptrs[5], (bf16*)ptrs[6], (float*)ptrs[7]};
}

}  // namespace

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    cudaError_t err_ = (expr);             \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

extern "C" const char* msmd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

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
  if (F % H || F / H != DH || F % BN || FF % BN || F % BK || FF % BK || F > 32 * LN_MAXN || lq < 2 ||
      lq > MAX_LM)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = Be * lq, lm = lq - 1;
  size_t total = 0;
  Workspace w = carve(ws, Be, lq, F, FF, &total);
  float* x = static_cast<float*>(x_out);
  const int* rows = static_cast<const int*>(aux);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));

  static bool attr_set = false;
  if (!attr_set) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(self_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(att_smem_bytes(MAX_LM))));
    RETURN_IF_ERROR((gemm_attr<EPI_BF16, 64>()));
    RETURN_IF_ERROR((gemm_attr<EPI_BF16, 128>()));
    RETURN_IF_ERROR((gemm_attr<EPI_RESID, 64>()));
    RETURN_IF_ERROR((gemm_attr<EPI_RESID, 128>()));
    RETURN_IF_ERROR((gemm_attr<EPI_GELU, 64>()));
    RETURN_IF_ERROR((gemm_attr<EPI_GELU, 128>()));
    attr_set = true;
  }

  cast_kernel<<<1024, 256, 0, st>>>(static_cast<const float*>(x_in), x, w.xb, (long)R * F);
  RETURN_IF_ERROR(cudaGetLastError());

  const int ln_blocks = (R * 32 + LN_THREADS - 1) / LN_THREADS;
  for (int l = 0; l < L; ++l) {
    const bf16* Wqkv = static_cast<const bf16*>(wqkv) + (size_t)l * F * 3 * F;
    const bf16* Bqkv = static_cast<const bf16*>(bqkv) + (size_t)l * 3 * F;
    const bf16* Wso = static_cast<const bf16*>(wso) + (size_t)l * F * F;
    const bf16* Bso = static_cast<const bf16*>(bso) + (size_t)l * F;
    const bf16* Wcq = static_cast<const bf16*>(wcq) + (size_t)l * F * F;
    const bf16* Bcq = static_cast<const bf16*>(bcq) + (size_t)l * F;
    const bf16* Wco = static_cast<const bf16*>(wco) + (size_t)l * F * F;
    const bf16* Bco = static_cast<const bf16*>(bco) + (size_t)l * F;
    const bf16* Wf1 = static_cast<const bf16*>(wf1) + (size_t)l * F * FF;
    const bf16* Bf1 = static_cast<const bf16*>(bf1) + (size_t)l * FF;
    const bf16* Wf2 = static_cast<const bf16*>(wf2) + (size_t)l * FF * F;
    const bf16* Bf2 = static_cast<const bf16*>(bf2) + (size_t)l * F;
    const float* lns = static_cast<const float*>(ln_scale) + (size_t)l * 3 * F;
    const float* lnb = static_cast<const float*>(ln_bias) + (size_t)l * 3 * F;
    const bf16* Km = static_cast<const bf16*>(kmem) + (size_t)l * Be * lm * F;
    const bf16* Vm = static_cast<const bf16*>(vmem) + (size_t)l * Be * lm * F;
    const bf16* Vmw = static_cast<const bf16*>(vmw) + (size_t)l * R * F;

    // self-attention
    RETURN_IF_ERROR(gemm<EPI_BF16>(st, w.xb, F, nullptr, Wqkv, Bqkv, nullptr, w.qkv, R, 3 * F, F, scale, F));
    self_attn_kernel<<<dim3(H, Be), ATT_THREADS, att_smem_bytes(lq), st>>>(w.qkv, w.sa, lq, F);
    RETURN_IF_ERROR(cudaGetLastError());
    RETURN_IF_ERROR(gemm<EPI_RESID>(st, w.sa, F, nullptr, Wso, Bso, x, w.y, R, F, F));
    ln_kernel<false><<<ln_blocks, LN_THREADS, 0, st>>>(w.y, x, w.xb, lns, lnb, R, F, nullptr, nullptr,
                                                       nullptr, nullptr, lq);
    RETURN_IF_ERROR(cudaGetLastError());

    // identity-band cross-attention: person rows attend, motion rows add vmw
    RETURN_IF_ERROR(gemm<EPI_BF16>(st, w.xb, F, rows, Wcq, Bcq, nullptr, w.qp, Be, F, F, scale, F));
    person_attn_kernel<<<Be, H * 32, H * (DH + MAX_LM) * sizeof(float), st>>>(w.qp, Km, Vm, w.pa, lm, F);
    RETURN_IF_ERROR(cudaGetLastError());
    RETURN_IF_ERROR(gemm<EPI_BF16>(st, w.pa, F, nullptr, Wco, nullptr, nullptr, w.po, Be, F, F));
    ln_kernel<true><<<ln_blocks, LN_THREADS, 0, st>>>(nullptr, x, w.xb, lns + F, lnb + F, R, F, w.po, Vmw,
                                                      Bco, rows, lq);
    RETURN_IF_ERROR(cudaGetLastError());

    // FFN
    RETURN_IF_ERROR(gemm<EPI_GELU>(st, w.xb, F, nullptr, Wf1, Bf1, nullptr, w.h, R, FF, F));
    RETURN_IF_ERROR(gemm<EPI_RESID>(st, w.h, FF, nullptr, Wf2, Bf2, x, w.y, R, F, FF));
    ln_kernel<false><<<ln_blocks, LN_THREADS, 0, st>>>(w.y, x, w.xb, lns + 2 * F, lnb + 2 * F, R, F, nullptr,
                                                       nullptr, nullptr, nullptr, lq);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  return cudaSuccess;
}
