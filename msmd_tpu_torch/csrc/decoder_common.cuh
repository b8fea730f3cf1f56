// Device code shared by the decoder-stack kernel (decoder.cu, K1), the
// batch-1 sampler kernels (sampler.cu, K3 and K4) and the layer kernels of
// the XLA-decoder route (ffn.cu K6, attn.cu K8, layer_tail.cu K9): the
// tiled wmma bf16 GEMM with fused epilogues (its B operand in the (in, out)
// layout, or in the nn.Linear (out, in) layout with BT), the Hopper wgmma
// GEMM of the decoder's large products (gemm_sm90.cuh, included below,
// chosen per product by gemm_bf16_out and gemm_resid_ln), per-(entry, head)
// self-attention, the identity-band person-row cross-attention, the
// LayerNorm variants, and the host loop that launches one decoder stack on
// a stream.
//
// Each kernel library is one translation unit that includes this header
// once, so everything here has internal linkage (an anonymous namespace)
// except msmd_error_string, which every library exports for its wrapper.
//
// Rounding follows msmd_tpu/ops/pallas/decoder_kernel.py::_layer_compute:
// every product rounds its left operand to bf16 and accumulates in f32,
// biases are added in f32, the activations x stay f32 with a bf16 copy xb
// that the next product reads, q is scaled in f32 before its cast, and the
// softmax is the bf16 "fast" form exp(clamp(s - 20, -80, 60)) normalised
// after the PV product. K1's identity-band cross output is
// scatter(bf16(bf16(person_out) @ wco)) + bf16 vmw + bco; K3's and K4's
// (decoder_small.cuh) round it elsewhere.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    cudaError_t err_ = (expr);             \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

extern "C" const char* msmd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

namespace {

using namespace nvcuda;

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

// gelu_tanh through the exp and reciprocal intrinsics (ex2.approx,
// rcp.approx): 0.5 x (1 + tanh(v)) = x / (1 + exp(-2 v)); it agrees with
// gelu_tanh to f32 rounding (~1e-7 relative) at a fraction of the
// instructions of tanhf, whose slow-path branches also keep the compiler
// from overlapping the elements of an epilogue (the wgmma GEMMs' GELU
// epilogues of K1, K2, K6 and K9)
__device__ __forceinline__ float gelu_tanh_fast(float x) {
  const float v = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return __fdividef(x, 1.0f + __expf(-2.0f * v));
}

// erf by Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7), as
// msmd_tpu/ops/pallas/decoder_kernel.py::_erf computes it
__device__ __forceinline__ float erf_as(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f, a4 = -1.453152027f,
              a5 = 1.061405429f, p = 0.3275911f;
  const float sign = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + p * ax);
  const float poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t;
  return sign * (1.0f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_erf(float u) { return u * 0.5f * (1.0f + erf_as(u * 0.70710677f)); }

// the bf16 "fast" softmax numerator: exp(clamp(s - 20, -80, 60))
__device__ __forceinline__ float fast_exp(float s) {
  return expf(fminf(fmaxf(s - 20.0f, -80.0f), 60.0f));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

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
// B is K x N row-major, or with BT N x K row-major (the nn.Linear layout,
// staged as BN rows of BK and read through col-major fragments).
constexpr int BN = 128, BK = 32, PAD = 8, STAGES = 4, GEMM_THREADS = 256;
constexpr int A_LD = BK + PAD, B_LD = BN + PAD, BT_LD = BK + PAD, C_LD = 16 + 4;

// EPI_BF16: bf16(scaled acc + bias); EPI_RESID: f32 res + (acc + bias);
// EPI_GELU: bf16(gelu_tanh(acc + bias)); EPI_F32: f32 acc + bias;
// EPI_RESID_BF16: f32(bf16 res_b) + (acc + bias) in f32;
// EPI_GELU_ERF: bf16(gelu_erf(acc + bias)).
enum { EPI_BF16 = 0, EPI_RESID = 1, EPI_GELU = 2, EPI_F32 = 3, EPI_RESID_BF16 = 4, EPI_GELU_ERF = 5 };

struct GemmArgs {
  const bf16* A;
  long lda;
  const int* a_rows;     // optional: A row r is A[a_rows[r]]
  const bf16* B;         // K x N row-major (the JAX (in, out) layout)
  const bf16* bias;      // N, or null
  const float* bias_f;   // N f32, or null (added after `bias`)
  const float* res;      // M x N f32 residual (EPI_RESID)
  void* C;               // M x N: bf16 (EPI_BF16, EPI_GELU*) or f32 (EPI_RESID*, EPI_F32)
  int M, N, K;
  float scale;     // EPI_BF16: columns < scale_cols are multiplied by scale
  int scale_cols;  // before the bf16 cast
  const bf16* res_b;  // M x N bf16 residual (EPI_RESID_BF16)
};

template <bool BT>
__host__ __device__ constexpr int b_stage_elems() { return BT ? BN * BT_LD : BK * B_LD; }

template <int BM, bool BT = false>
constexpr size_t gemm_smem_bytes() {
  return (size_t)STAGES * (BM * A_LD + b_stage_elems<BT>()) * sizeof(bf16) +
         (GEMM_THREADS / 32) * 16 * C_LD * sizeof(float);
}

// One BM x BN output tile (tile_m, tile_n) by the whole block of
// GEMM_THREADS threads, in the shared memory `gsm` (gemm_smem_bytes). The
// leading barrier lets a persistent block (K2) run tiles back to back.
template <int EPI, int BM, bool BT = false>
__device__ __forceinline__ void gemm_tile(const GemmArgs& g, int tile_m, int tile_n, unsigned char* gsm) {
  constexpr int MI = BM / 32;  // 16-row fragments per warp
  constexpr int B_ELEMS = b_stage_elems<BT>();
  using BLayout = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  bf16* As = reinterpret_cast<bf16*>(gsm);            // [STAGES][BM][A_LD]
  bf16* Bs = As + STAGES * BM * A_LD;                 // [STAGES][BK][B_LD], or with BT [STAGES][BN][BT_LD]
  float* Cs = reinterpret_cast<float*>(Bs + STAGES * B_ELEMS);  // [8 warps][16][C_LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = tile_m * BM, n0 = tile_n * BN;
  __syncthreads();  // the previous tile of this block is done with the ring

  auto load_tile = [&](int stage, int k0) {
    bf16* as = As + stage * BM * A_LD;
    bf16* bs = Bs + stage * B_ELEMS;
    for (int i = tid; i < BM * (BK / 8); i += GEMM_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8, gr = m0 + r;
      const bool ok = gr < g.M;
      const bf16* src = g.A;
      if (ok) src = g.A + (long)(g.a_rows ? g.a_rows[gr] : gr) * g.lda + k0 + c;
      cp_async16(as + r * A_LD + c, src, ok);
    }
    if (BT) {  // BN rows of n, BK columns of k
      for (int i = tid; i < BN * (BK / 8); i += GEMM_THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        cp_async16(bs + r * BT_LD + c, g.B + (long)(n0 + r) * g.K + k0 + c, true);
      }
    } else {  // BK rows of k, BN columns of n
      for (int i = tid; i < BK * (BN / 8); i += GEMM_THREADS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        cp_async16(bs + r * B_LD + c, g.B + (long)(k0 + r) * g.N + n0 + c, true);
      }
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
    const bf16* bs = Bs + (kt % STAGES) * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[MI];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < MI; ++i) wmma::load_matrix_sync(a[i], as + (wm * (BM / 2) + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nc = wn * 32 + j * 16;
        if (BT) {
          wmma::load_matrix_sync(b[j], bs + nc * BT_LD + kk, BT_LD);
        } else {
          wmma::load_matrix_sync(b[j], bs + kk * B_LD + nc, B_LD);
        }
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
        if (g.bias_f) {
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] += g.bias_f[gc + t];
        }
        const long o = (long)gr * g.N + gc;
        if (EPI == EPI_RESID || EPI == EPI_F32 || EPI == EPI_RESID_BF16) {
          float4 r0 = make_float4(0.f, 0.f, 0.f, 0.f), r1 = r0;
          if (EPI == EPI_RESID) {
            r0 = *reinterpret_cast<const float4*>(g.res + o);
            r1 = *reinterpret_cast<const float4*>(g.res + o + 4);
          } else if (EPI == EPI_RESID_BF16) {
            const uint4 ur = *reinterpret_cast<const uint4*>(g.res_b + o);
            const bf16* r8 = reinterpret_cast<const bf16*>(&ur);
            r0 = make_float4(__bfloat162float(r8[0]), __bfloat162float(r8[1]), __bfloat162float(r8[2]),
                             __bfloat162float(r8[3]));
            r1 = make_float4(__bfloat162float(r8[4]), __bfloat162float(r8[5]), __bfloat162float(r8[6]),
                             __bfloat162float(r8[7]));
          }
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
            if (EPI == EPI_GELU_ERF) y = gelu_erf(y);
            p8[t] = __float2bfloat16(y);
          }
          *reinterpret_cast<uint4*>(static_cast<bf16*>(g.C) + o) = packed;
        }
      }
      __syncwarp();
    }
  }
}

template <int EPI, int BM, bool BT = false>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  extern __shared__ __align__(128) unsigned char gsm[];
  gemm_tile<EPI, BM, BT>(g, blockIdx.y, blockIdx.x, gsm);
}

template <int EPI, int BM, bool BT = false>
cudaError_t gemm_attr() {
  return cudaFuncSetAttribute(gemm_kernel<EPI, BM, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(gemm_smem_bytes<BM, BT>()));
}

// K % BK == 0 and N % BN == 0; M is ragged. With BT, B is (N, K) row-major.
template <int EPI, bool BT = false>
cudaError_t gemm(cudaStream_t st, const bf16* A, long lda, const int* a_rows, const bf16* B,
                 const bf16* bias, const float* res, void* C, int M, int N, int K,
                 float scale = 1.0f, int scale_cols = 0, const float* bias_f = nullptr,
                 const bf16* res_b = nullptr) {
  GemmArgs g{A, lda, a_rows, B, bias, bias_f, res, C, M, N, K, scale, scale_cols, res_b};
  if (N > 512) {
    gemm_kernel<EPI, 128, BT><<<dim3(N / BN, (M + 127) / 128), GEMM_THREADS, gemm_smem_bytes<128, BT>(), st>>>(g);
  } else {
    gemm_kernel<EPI, 64, BT><<<dim3(N / BN, (M + 63) / 64), GEMM_THREADS, gemm_smem_bytes<64, BT>(), st>>>(g);
  }
  return cudaGetLastError();
}

// The dynamic shared-memory limit of both tile heights of one product.
template <int EPI, bool BT>
cudaError_t gemm_attrs() {
  RETURN_IF_ERROR((gemm_attr<EPI, 64, BT>()));
  return gemm_attr<EPI, 128, BT>();
}

}  // namespace

#include "gemm_sm90.cuh"

namespace {

// --------------------------------------------------------------------------
// mma.sync building blocks (K8 and the per-entry self-attention)
// --------------------------------------------------------------------------

// byte offset of 16-byte chunk c of row r in a [rows][64] bf16 tile with
// the 128-byte XOR swizzle (chunk c of row r at c ^ (r % 8)), which makes
// the ldmatrix loads below free of bank conflicts
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16 x 16 bf16, row) b (16 x 8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --------------------------------------------------------------------------
// per-entry self-attention: one (entry, head) per block, scores in registers
// --------------------------------------------------------------------------

constexpr int MAX_LM = 128;       // the longest rows the decoder kernels take
constexpr int ATT_THREADS = 256;  // 8 warps: one per 16 query rows, lq <= MAX_LM

__host__ __device__ inline int att_lp(int lq) { return (lq + 15) / 16 * 16; }

// Q, K, V of one head, each [lp][64] bf16 in the swizzle.
inline size_t att_smem_bytes(int lq) { return (size_t)3 * att_lp(lq) * 128; }

// qkv: (Be*lq, 3F) bf16 with q already scaled; out: (Be*lq, F) bf16.
// Entry e, head h, by a block of ATT_THREADS threads in `smem`
// (att_smem_bytes). Q, K, V come in by cp.async (rows past lq
// zero-filled; V lands while S is computed); warp w < ceil(lq / 16) holds
// the 16 x lp scores of query rows 16w.. in registers (mma.sync m16n8k16,
// f32), takes the bf16 "fast" numerators exp(clamp(s - 20, -80, 60)) of
// the lq real keys (padded keys get no weight, as the TPU kernels' pad-row
// key mask gives them none) with their f32 row sums over the lane quads,
// feeds the bf16 numerators to P V as the A operand and divides by the
// row sum after it, as the wmma design of earlier PRs did.
__device__ __forceinline__ void self_attn_block(const bf16* __restrict__ qkv, bf16* __restrict__ out, int lq,
                                                int F, int h, int e, unsigned char* smem) {
  constexpr int NT = MAX_LM / 16;  // register tiles for the longest rows; tiles past nt are skipped
  __syncthreads();  // the previous item of this block is done with smem
  const int nt = (lq + 15) / 16, lp = nt * 16;
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + lp * 128;
  unsigned char* Vs = Ks + lp * 128;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long row0 = (long)e * lq, ld = 3L * F;

  for (int i = tid; i < lp * 8; i += ATT_THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < lq;
    const bf16* base = qkv + (row0 + (ok ? r : 0)) * ld + h * DH + c * 8;
    cp_async16(Qs + swz(r, c), base, ok);
    cp_async16(Ks + swz(r, c), base + F, ok);
  }
  cp_async_commit();
  for (int i = tid; i < lp * 8; i += ATT_THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < lq;
    cp_async16(Vs + swz(r, c), qkv + (row0 + (ok ? r : 0)) * ld + 2 * F + h * DH + c * 8, ok);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const bool active = warp < nt;
  const int qr = warp * 16, lr = (lane & 7) + ((lane >> 3) & 1) * 8, c2 = 2 * (lane & 3);
  uint32_t p[NT][4];  // bf16 numerators as the A fragments of keys 16j .. 16j + 15
  float l_lo = 0.0f, l_hi = 0.0f;
  if (active) {
    float s[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(smem_u32(Qs + swz(qr + lr, kk * 2 + (lane >> 4))), a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_u32(Ks + swz(j * 16 + (lane & 7) + (lane >> 4) * 8, kk * 2 + ((lane >> 3) & 1))), b0, b1,
                  b2, b3);
          mma_bf16(s[2 * j], a, b0, b1);
          mma_bf16(s[2 * j + 1], a, b2, b3);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const bool key = 8 * j + c2 + t < lq;
        s[j][t] = key ? fast_exp(s[j][t]) : 0.0f;
        s[j][2 + t] = key ? fast_exp(s[j][2 + t]) : 0.0f;
        l_lo += s[j][t];
        l_hi += s[j][2 + t];
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      p[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      p[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      p[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      p[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
    }
  }
  cp_async_wait<0>();  // V
  __syncthreads();
  if (!active) return;

  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_u32(Vs + swz(j * 16 + lr, nd * 2 + (lane >> 4))), b0, b1, b2, b3);
        mma_bf16(o[2 * nd], p[j], b0, b1);
        mma_bf16(o[2 * nd + 1], p[j], b2, b3);
      }
    }
  }
  // O / row sum in bf16 over this warp's own Q rows, then 16-byte row stores
  const float i_lo = 1.0f / l_lo, i_hi = 1.0f / l_hi;
  const int g = lane >> 2;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    *reinterpret_cast<uint32_t*>(Qs + swz(qr + g, n) + 2 * c2) = pack_bf16(o[n][0] * i_lo, o[n][1] * i_lo);
    *reinterpret_cast<uint32_t*>(Qs + swz(qr + g + 8, n) + 2 * c2) = pack_bf16(o[n][2] * i_hi, o[n][3] * i_hi);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3, c = i & 7;
    if (qr + r < lq)
      *reinterpret_cast<uint4*>(out + (row0 + qr + r) * F + h * DH + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz(qr + r, c));
  }
}

__global__ void __launch_bounds__(ATT_THREADS) self_attn_kernel(const bf16* __restrict__ qkv,
                                                                bf16* __restrict__ out, int lq, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  self_attn_block(qkv, out, lq, F, blockIdx.x, blockIdx.y, smem);
}

// --------------------------------------------------------------------------
// identity-band person-row cross-attention: block per entry, warp per head
// --------------------------------------------------------------------------


// Entry e's person row, one warp per head (warps loop over the H heads),
// each warp with DH + MAX_LM floats of `psm`. qp: (Be, F) bf16, scaled;
// km, vm: (Be*lm, F) bf16; out: (Be, F) bf16.
__device__ __forceinline__ void person_attn_block(const bf16* __restrict__ qp, const bf16* __restrict__ km,
                                                  const bf16* __restrict__ vm, bf16* __restrict__ out, int lm,
                                                  int F, int H, int e, float* psm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  float* qs = psm + warp * (DH + MAX_LM);
  float* es = qs + DH;
  for (int h = warp; h < H; h += nwarps) {
    __syncwarp();  // the warp's previous head is done with qs and es
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
}

// block per entry, H * 32 threads (a warp per head)
__global__ void person_attn_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ km,
                                   const bf16* __restrict__ vm, bf16* __restrict__ out, int lm, int F) {
  extern __shared__ float psm[];
  person_attn_block(qp, km, vm, out, lm, F, blockDim.x / 32, blockIdx.x, psm);
}

// --------------------------------------------------------------------------
// LayerNorm, one warp per row (F <= 1024); writes x (f32, unless x is null
// outside CROSS) and its bf16 copy
// --------------------------------------------------------------------------

constexpr int LN_THREADS = 256, LN_MAXN = 32;

// One row by one warp. CROSS = false: y is the residual sum. CROSS = true:
// the row is x + ((person row ? po[e] : 0) + vmw + bco), the identity-band
// cross step, with po and vmw of type T (bf16 for K1, f32 for K3).
template <bool CROSS, typename T>
__device__ __forceinline__ void ln_row(int row, int lane, const float* y, float* x, bf16* xb,
                                       const float* __restrict__ scale, const float* __restrict__ bias, int F,
                                       const T* po, const T* vmw, const bf16* bco, const int* aux, int lq) {
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
        float ca = (pe >= 0 ? to_f32(po[(long)pe * F + c]) : 0.0f) + to_f32(vmw[base + c]);
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
      if (x) x[base + c] = o;
      xb[base + c] = __float2bfloat16(o);
    }
  }
}

// The cross LayerNorm of the Be person rows aux[e] alone, a warp a row
// (where the self-out product's epilogue took the motion rows').
__global__ void __launch_bounds__(LN_THREADS) ln_person_kernel(float* x, bf16* xb, const float* __restrict__ scale,
                                                               const float* __restrict__ bias, int Be, int F,
                                                               const bf16* po, const bf16* vmw, const bf16* bco,
                                                               const int* aux, int lq) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (e >= Be) return;
  ln_row<true, bf16>(aux[e], threadIdx.x % 32, nullptr, x, xb, scale, bias, F, po, vmw, bco, aux, lq);
}

template <bool CROSS, typename T>
__global__ void __launch_bounds__(LN_THREADS) ln_kernel(const float* y, float* x, bf16* xb,
                                                        const float* __restrict__ scale,
                                                        const float* __restrict__ bias, int R, int F,
                                                        const T* po, const T* vmw, const bf16* bco,
                                                        const int* aux, int lq) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (row >= R) return;
  ln_row<CROSS, T>(row, threadIdx.x % 32, y, x, xb, scale, bias, F, po, vmw, bco, aux, lq);
}

// --------------------------------------------------------------------------
// a product on the Hopper GEMM where its shape takes it (gemm_sm90.cuh),
// else on the wmma tile
// --------------------------------------------------------------------------

// C (bf16) = EPI(A @ B + bias): EPI_BF16 (columns < scale_cols scaled) or
// EPI_GELU. The Hopper GEMM reads A and B through the tensor maps ma and
// mb (B's layer `layer`); the wmma tile through the pointers.
template <int EPI>
cudaError_t gemm_bf16_out(cudaStream_t st, const CUtensorMap* ma, const CUtensorMap* mb, int layer, const bf16* A,
                          long lda, const bf16* B, const bf16* bias, bf16* C, int M, int N, int K,
                          float scale = 1.0f, int scale_cols = 0) {
  if (sm90_wide_ok(M, N, K)) {
    if (ma == nullptr || mb == nullptr) return cudaErrorInvalidValue;
    return gemm_sm90<EPI>(st, *ma, *mb, Sm90Args{nullptr, nullptr, layer, bias, nullptr, C, nullptr, nullptr,
                                                 nullptr, M, N, K, scale, scale_cols});
  }
  return gemm<EPI>(st, A, lda, nullptr, B, bias, nullptr, C, M, N, K, scale, scale_cols);
}

// x, xb = LayerNorm(x + (A @ B + bias)) * lns + lnb: one launch with the
// LayerNorm in the Hopper GEMM's epilogue where it takes the shape, else
// the wmma tile into the scratch y and a LayerNorm pass.
cudaError_t gemm_resid_ln(cudaStream_t st, const CUtensorMap* ma, const CUtensorMap* mb, int layer, const bf16* A,
                          long lda, const bf16* B, const bf16* bias, float* x, bf16* xb, float* y, const float* lns,
                          const float* lnb, int M, int N, int K) {
  if (sm90_ln_ok(M, N, K)) {
    if (ma == nullptr || mb == nullptr) return cudaErrorInvalidValue;
    return gemm_sm90<EPI_RESID_LN>(st, *ma, *mb, Sm90Args{nullptr, nullptr, layer, bias, x, x, xb, lns, lnb, M, N, K,
                                                          1.0f, 0});
  }
  RETURN_IF_ERROR(gemm<EPI_RESID>(st, A, lda, nullptr, B, bias, x, y, M, N, K));
  ln_kernel<false, bf16><<<(M * 32 + LN_THREADS - 1) / LN_THREADS, LN_THREADS, 0, st>>>(
      y, x, xb, lns, lnb, M, N, nullptr, nullptr, nullptr, nullptr, 1);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// the decoder stack on a stream
// --------------------------------------------------------------------------

inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

struct Workspace {
  bf16 *xb, *qkv, *sa, *h, *qp, *pa;
  void* po;  // (Be, F) bf16 (sized for f32)
  float* y;
};

// Carves the decoder's scratch out of `ws` (null: only sizes it) and
// returns the bytes it takes in `*total`.
Workspace carve(void* ws, int Be, int lq, int F, int FF, size_t* total) {
  const size_t R = (size_t)Be * lq;
  const size_t sizes[8] = {R * F * 2, R * 3 * F * 2, R * F * 2, R * FF * 2,
                           (size_t)Be * F * 2, (size_t)Be * F * 2, (size_t)Be * F * 4, R * F * 4};
  char* p = static_cast<char*>(ws);
  void* ptrs[8];
  size_t off = 0;
  for (int i = 0; i < 8; ++i) {
    ptrs[i] = p ? p + off : nullptr;
    off += align256(sizes[i]);
  }
  *total = off;
  return Workspace{(bf16*)ptrs[0], (bf16*)ptrs[1], (bf16*)ptrs[2], (bf16*)ptrs[3],
                   (bf16*)ptrs[4], (bf16*)ptrs[5], ptrs[6], (float*)ptrs[7]};
}

// The tensor maps of one decoder call's Hopper products: the activations
// read as A (xb by QKV, FFN1 and the flat mode's full-cross q in 128-row
// boxes; sa and h by the residual products in 64-row boxes) and each
// weight stack over the L layers. Built on the host once per call (the
// workspace is the call's).
struct DecoderMaps {
  CUtensorMap xb, sa, h, wqkv, wso, wcq, wco, wf1, wf2;
};

struct DecoderWeights {
  const bf16 *wqkv, *bqkv, *wso, *bso, *wcq, *bcq, *wco, *bco, *wf1, *bf1, *wf2, *bf2;
  const float *ln_scale, *ln_bias;
  const bf16 *kmem, *vmem;
  const void* vmw;  // (L, Be*lq, F): bf16 for K1 (f32 for K3's small-row stack), null for K4
};

// Whether any of a layer's four large products takes the Hopper GEMM at R
// rows.
__host__ __device__ inline bool decoder_uses_sm90(int R, int F, int FF) {
  return sm90_wide_ok(R, 3 * F, F) || sm90_wide_ok(R, FF, F) || sm90_ln_ok(R, F, F) || sm90_ln_ok(R, F, FF);
}

cudaError_t make_decoder_maps(DecoderMaps* m, const Workspace& w, const DecoderWeights& p, int R, int F, int FF,
                              int L) {
  RETURN_IF_ERROR(make_a_map(&m->xb, w.xb, F, R, F, 128));
  RETURN_IF_ERROR(make_a_map(&m->sa, w.sa, F, R, F, 64));
  RETURN_IF_ERROR(make_a_map(&m->h, w.h, FF, R, FF, 64));
  RETURN_IF_ERROR(make_b_map(&m->wqkv, p.wqkv, F, 3 * F, L));
  RETURN_IF_ERROR(make_b_map(&m->wso, p.wso, F, F, L));
  RETURN_IF_ERROR(make_b_map(&m->wcq, p.wcq, F, F, L));
  RETURN_IF_ERROR(make_b_map(&m->wco, p.wco, F, F, L));
  RETURN_IF_ERROR(make_b_map(&m->wf1, p.wf1, F, FF, L));
  return make_b_map(&m->wf2, p.wf2, FF, F, L);
}

inline bool decoder_shapes_ok(int lq, int F, int H, int FF) {
  return !(F % H || F / H != DH || F % BN || FF % BN || F % BK || FF % BK || F > 32 * LN_MAXN || lq < 2 ||
           lq > MAX_LM);
}

// Raises the dynamic shared-memory limit of every kernel launched below
// (once per library).
cudaError_t set_kernel_attributes() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  RETURN_IF_ERROR(cudaFuncSetAttribute(self_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(att_smem_bytes(MAX_LM))));
  RETURN_IF_ERROR((gemm_attr<EPI_BF16, 64>()));
  RETURN_IF_ERROR((gemm_attr<EPI_BF16, 128>()));
  RETURN_IF_ERROR((gemm_attr<EPI_RESID, 64>()));
  RETURN_IF_ERROR((gemm_attr<EPI_RESID, 128>()));
  RETURN_IF_ERROR((gemm_attr<EPI_GELU, 64>()));
  RETURN_IF_ERROR((gemm_attr<EPI_GELU, 128>()));
  attr_set = true;
  return cudaSuccess;
}

// All L layers of K1 per-entry on x (Be*lq, F) f32, whose bf16 copy w.xb
// is already written; rows (Be,) are the person rows e*lq. Eleven launches
// per layer, nine where the Hopper GEMM takes the residual products with
// their LayerNorms (R >= SM90_MIN_ROWS); there the self-out product's
// epilogue also takes the motion rows' cross step and its LayerNorm, and
// the cross LayerNorm launch covers the person rows only.
cudaError_t decoder_layers(cudaStream_t st, const Workspace& w, float* x, const DecoderWeights& p,
                           const int* rows, int Be, int lq, int F, int H, int L, int FF) {
  const int R = Be * lq, lm = lq - 1;
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  const int ln_blocks = (R * 32 + LN_THREADS - 1) / LN_THREADS;
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

    const bf16* Vmw = static_cast<const bf16*>(p.vmw) + (size_t)l * R * F;
    const bool fused = sm90_ln_ok(R, F, F);

    // self-attention
    RETURN_IF_ERROR(gemm_bf16_out<EPI_BF16>(st, map(maps.xb), map(maps.wqkv), l, w.xb, F, Wqkv, Bqkv, w.qkv, R,
                                            3 * F, F, scale, F));
    self_attn_kernel<<<dim3(H, Be), ATT_THREADS, att_smem_bytes(lq), st>>>(w.qkv, w.sa, lq, F);
    RETURN_IF_ERROR(cudaGetLastError());
    if (fused) {
      Sm90Args g{nullptr, nullptr, l, Bso, x, x, w.xb, lns, lnb, R, F, F, 1.0f, 0};
      g.vmw = Vmw;
      g.bco = Bco;
      g.ln2_scale = lns + F;
      g.ln2_bias = lnb + F;
      g.aux = rows;
      g.lq = lq;
      RETURN_IF_ERROR(gemm_sm90<EPI_RESID_LN_CROSS>(st, maps.sa, maps.wso, g));
    } else {
      RETURN_IF_ERROR(gemm_resid_ln(st, map(maps.sa), map(maps.wso), l, w.sa, F, Wso, Bso, x, w.xb, w.y, lns, lnb, R,
                                    F, F));
    }

    // identity-band cross-attention: person rows attend, motion rows take
    // the hoisted vmw
    RETURN_IF_ERROR(gemm<EPI_BF16>(st, w.xb, F, rows, Wcq, Bcq, nullptr, w.qp, Be, F, F, scale, F));
    person_attn_kernel<<<Be, H * 32, H * (DH + MAX_LM) * sizeof(float), st>>>(w.qp, Km, Vm, w.pa, lm, F);
    RETURN_IF_ERROR(cudaGetLastError());
    RETURN_IF_ERROR(gemm<EPI_BF16>(st, w.pa, F, nullptr, Wco, nullptr, nullptr, w.po, Be, F, F));
    if (fused)
      ln_person_kernel<<<(Be * 32 + LN_THREADS - 1) / LN_THREADS, LN_THREADS, 0, st>>>(
          x, w.xb, lns + F, lnb + F, Be, F, static_cast<const bf16*>(w.po), Vmw, Bco, rows, lq);
    else
      ln_kernel<true, bf16><<<ln_blocks, LN_THREADS, 0, st>>>(nullptr, x, w.xb, lns + F, lnb + F, R, F,
                                                              static_cast<const bf16*>(w.po), Vmw, Bco, rows, lq);
    RETURN_IF_ERROR(cudaGetLastError());

    // FFN
    RETURN_IF_ERROR(gemm_bf16_out<EPI_GELU>(st, map(maps.xb), map(maps.wf1), l, w.xb, F, Wf1, Bf1, w.h, R, FF, F));
    RETURN_IF_ERROR(gemm_resid_ln(st, map(maps.h), map(maps.wf2), l, w.h, FF, Wf2, Bf2, x, w.xb, w.y, lns + 2 * F,
                                  lnb + 2 * F, R, F, FF));
  }
  return cudaSuccess;
}

}  // namespace
