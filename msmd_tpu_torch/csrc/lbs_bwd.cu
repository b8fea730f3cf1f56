// K5 backward: the skinning part of the VJP of the fused FLAME decode,
// hand-written for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes).
//
// Replaces the skinning terms of msmd_tpu/ops/pallas/lbs_kernel.py::
// FusedFlame.skin_fn's custom VJP (bwd, a chain of jnp einsums, not a
// pallas_call). For every frame b and vertex v, with g the cotangent of the
// output (N, V, 3), p_c the posed vertex (template + betas_ext . dirs,
// recomputed by the caller) and rt[b] the five joints' [R | t] rows:
//   M_v          = sum_j w[j, v] R_j
//   dv_c[b, v]   = sum_d g[b, v, d] M_v[d, c]            (3, N, Vp), f32
//   dR[b, j, d, c] = sum_v g[b, v, d] w[j, v] p_c[b, v]
//   dt[b, j, d]    = sum_v g[b, v, d] w[j, v]           -> d_rt (N, 60)
// JAX forms gw = g w_j as a (3, N, Vp, 5) tensor (541 MB of f32 at
// N = 1760); here it lives in registers, one vertex at a time.
//
// What bounds it on an H100 SXM: at N = 1760 frames (batch 16 x 110), V =
// 5023 it reads g (106 MB) and the planes (108 MB) once and writes dv
// (108 MB): ~323 MB, 0.096 ms at 3.35 TB/s. The arithmetic is 210 flops a
// vertex (1.9 GFLOP, 0.03 ms on the f32 CUDA cores). So it is bound by
// bytes, and the design reads each input once, coalesced:
// - lbs_bwd_kernel: one 256-thread block a (frame, tile of 2560 vertices:
//   two tiles cover FLAME's Vp = 5120), 10 vertices a thread, each
//   thread's 60 sums of dR and dt in registers;
//   dv is written as it is made (zero past V, so the caller's dv . dirs^T
//   over Vp reads no garbage). The block sums its threads' 60 values (warp
//   shuffles, then the 8 warps in order in shared memory) into one partial
//   row of (N, tiles, 60). That reduction costs a block ~650 instructions a
//   warp whatever its vertex count: at 4 vertices a thread (8800 blocks at
//   N = 1760) the kernel ran 0.229 ms, at 10 (3520 blocks) 0.188
//   (PERF.md section 6).
// - lbs_bwd_reduce_kernel sums each frame's partial rows over its tiles in
//   tile order into d_rt.
// No atomics: every sum is taken in one fixed order, so two calls give the
// same bits (the rule of gemm_train.cuh's split-K).

#include <cuda_runtime.h>

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    cudaError_t err_ = (expr);             \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

extern "C" const char* msmd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

namespace {

constexpr int NJ = 5, RT = NJ * 12;  // a frame's [R | t] rows: joint j, row d at 12 j + 4 d
constexpr int BWD_THREADS = 256;
constexpr int BWD_VPT = 10;                        // vertices a thread
constexpr int BWD_TILE = BWD_THREADS * BWD_VPT;    // vertices a block
constexpr int BWD_WARPS = BWD_THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// g (N, V, 3), planes (3, N, Vp), rt (N, 60), w (5, Vp) -> dv (3, N, Vp),
// part (N, tiles, 60): part[b, t, 12 j + 4 d + c] = dR[b, j, d, c] and
// part[b, t, 12 j + 4 d + 3] = dt[b, j, d] over tile t's vertices.
__global__ void __launch_bounds__(BWD_THREADS) lbs_bwd_kernel(const float* __restrict__ g,
                                                              const float* __restrict__ planes,
                                                              const float* __restrict__ rt,
                                                              const float* __restrict__ w, float* __restrict__ dv,
                                                              float* __restrict__ part, int N, int V, int Vp,
                                                              int tiles) {
  __shared__ float R[RT];
  __shared__ float red[BWD_WARPS][RT];
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < RT) R[tid] = rt[(long)b * RT + tid];
  __syncthreads();

  float acc[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i] = 0.0f;
  const long plane = (long)N * Vp;
#pragma unroll
  for (int k = 0; k < BWD_VPT; ++k) {
    const int v = tile * BWD_TILE + k * BWD_THREADS + tid;
    if (v >= Vp) continue;
    const long o = (long)b * Vp + v;
    if (v >= V) {
      dv[o] = 0.0f;
      dv[plane + o] = 0.0f;
      dv[2 * plane + o] = 0.0f;
      continue;
    }
    const float* gv = g + ((long)b * V + v) * 3;
    const float g0 = gv[0], g1 = gv[1], g2 = gv[2];
    const float p0 = planes[o], p1 = planes[plane + o], p2 = planes[2 * plane + o];
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float wj = w[(long)j * Vp + v];
      const float gw[3] = {g0 * wj, g1 * wj, g2 * wj};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int e = 12 * j + 4 * d;
        acc[e] += gw[d] * p0;
        acc[e + 1] += gw[d] * p1;
        acc[e + 2] += gw[d] * p2;
        acc[e + 3] += gw[d];
        d0 += gw[d] * R[e];
        d1 += gw[d] * R[e + 1];
        d2 += gw[d] * R[e + 2];
      }
    }
    dv[o] = d0;
    dv[plane + o] = d1;
    dv[2 * plane + o] = d2;
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float s = warp_sum(acc[i]);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  if (tid < RT) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < BWD_WARPS; ++i) s += red[i][tid];
    part[((long)b * tiles + tile) * RT + tid] = s;
  }
}

__global__ void lbs_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ drt, int N, int tiles) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)N * RT) return;
  const long b = i / RT;
  const int e = static_cast<int>(i % RT);
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += part[(b * tiles + t) * RT + e];
  drt[i] = s;
}

}  // namespace

// The vertices a block of lbs_bwd_kernel takes (the wrapper sizes the
// partials by it).
extern "C" int msmd_lbs_bwd_tile() { return BWD_TILE; }

// g (N, V, 3), planes (3, N, Vp), rt (N, 60), weights (5, Vp), dv (3, N,
// Vp) out, part (N, tiles, 60) scratch with tiles = ceil(Vp / tile), drt
// (N, 60) out; all f32 and contiguous. Launches lbs_bwd_kernel and
// lbs_bwd_reduce_kernel on `stream`; returns the first CUDA error or 0.
extern "C" int msmd_lbs_backward(const float* g, const float* planes, const float* rt, const float* weights,
                                 float* dv, float* part, float* drt, int N, int V, int Vp, int tiles, void* stream) {
  if (N <= 0 || V <= 0 || Vp < V || tiles != (Vp + BWD_TILE - 1) / BWD_TILE) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lbs_bwd_kernel<<<static_cast<unsigned>((long)N * tiles), BWD_THREADS, 0, st>>>(g, planes, rt, weights, dv, part, N,
                                                                                  V, Vp, tiles);
  RETURN_IF_ERROR(cudaGetLastError());
  const long n = (long)N * RT;
  lbs_bwd_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(part, drt, N, tiles);
  return cudaGetLastError();
}
