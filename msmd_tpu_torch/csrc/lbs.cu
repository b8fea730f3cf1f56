// Fused FLAME vertex decode (blendshapes + 5-joint linear blend skinning),
// hand-written for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes).
//
// Replaces the forward of the TPU kernel msmd_tpu/ops/pallas/lbs_kernel.py::
// flame_vertices_fused (_fused_skin -> _lbs_kernel). For every frame n and
// vertex v:
//   p_c    = template_c[v] + sum_k betas_ext[n, k] * dirs[c, k, v]   (c = x, y, z)
//   out_d  = sum_j W[j, v] * (R_j[d, :] . p + t_j[d])
// with rt[n] holding the five joints' [R | t] rows. The per-vertex 4x4
// transforms and the posed-vertex planes never reach device memory; the
// kernel writes (N, V, 3) directly.
//
// What bounds it on an H100: at N = 4800 frames (batch 48 x 100) and
// Vp = 5120 it is ~27.4 GFLOP of f32 blendshape products plus ~3 GFLOP of
// skinning, ~0.46 ms at the 67 TFLOP/s f32 CUDA-core peak, against ~0.09 ms
// to write the 295 MB of output. It is compute-bound, in f32 on purpose: the
// output is compared at 1e-4 absolute and TF32 keeps about three digits.
//
// Design, simple first: an SGEMM-style register tile. A block owns 64 frames
// x 64 vertices; each of its 256 threads accumulates 4 frames x 4 vertices x
// 3 coordinates in registers while 16-deep slices of betas and of the three
// basis planes stream through shared memory; the skinning runs in the
// epilogue from the block's 64 [R | t] rows, also in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 64, TV = 64, KC = 16, LBS_THREADS = 256, NJ = 5, RT = NJ * 12;

__global__ void __launch_bounds__(LBS_THREADS) lbs_kernel(const float* __restrict__ betas,
                                                          const float* __restrict__ rt,
                                                          const float* __restrict__ dirs,
                                                          const float* __restrict__ tmpl,
                                                          const float* __restrict__ weights,
                                                          float* __restrict__ out, int N, int KB, int V, int Vp) {
  __shared__ float Bs[KC][TB];
  __shared__ float Ds[3][KC][TV];
  __shared__ float Rs[TB][RT];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b0 = blockIdx.y * TB, v0 = blockIdx.x * TV;
  float acc[3][4][4];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][i][j] = 0.0f;

  for (int k0 = 0; k0 < KB; k0 += KC) {
    for (int i = tid; i < TB * KC; i += LBS_THREADS) {
      const int b = i / KC, k = i % KC, gb = b0 + b, gk = k0 + k;
      Bs[k][b] = (gb < N && gk < KB) ? betas[(long)gb * KB + gk] : 0.0f;
    }
    for (int i = tid; i < 3 * KC * TV; i += LBS_THREADS) {
      const int c = i / (KC * TV), k = (i / TV) % KC, v = i % TV, gk = k0 + k, gv = v0 + v;
      Ds[c][k][v] = (gk < KB && gv < Vp) ? dirs[((long)c * KB + gk) * Vp + gv] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = Bs[k][ty * 4 + i];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float d = Ds[c][k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[c][i][j] += bv[i] * d;
        }
    }
    __syncthreads();
  }

  for (int i = tid; i < TB * RT; i += LBS_THREADS) {
    const int b = i / RT, q = i % RT;
    Rs[b][q] = (b0 + b < N) ? rt[(long)(b0 + b) * RT + q] : 0.0f;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int bl = ty * 4 + i, b = b0 + bl;
    if (b >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx + 16 * j;
      if (v >= V) continue;
      const float px = tmpl[v] + acc[0][i][j];
      const float py = tmpl[Vp + v] + acc[1][i][j];
      const float pz = tmpl[2 * Vp + v] + acc[2][i][j];
      float ox = 0.0f, oy = 0.0f, oz = 0.0f;
#pragma unroll
      for (int jt = 0; jt < NJ; ++jt) {
        const float w = weights[jt * Vp + v];
        const float* r = &Rs[bl][jt * 12];
        ox += w * (r[0] * px + r[1] * py + r[2] * pz + r[3]);
        oy += w * (r[4] * px + r[5] * py + r[6] * pz + r[7]);
        oz += w * (r[8] * px + r[9] * py + r[10] * pz + r[11]);
      }
      float* o = out + ((long)b * V + v) * 3;
      o[0] = ox;
      o[1] = oy;
      o[2] = oz;
    }
  }
}

}  // namespace

extern "C" const char* msmd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// betas (N, KB), rt (N, 60), dirs (3, KB, Vp), tmpl (3, Vp), weights (5, Vp),
// out (N, V, 3); all f32, contiguous. Launches on `stream`; returns the
// launch's CUDA error or 0.
extern "C" int msmd_lbs_forward(const float* betas, const float* rt, const float* dirs, const float* tmpl,
                                const float* weights, float* out, int N, int KB, int V, int Vp, void* stream) {
  if (N <= 0 || V <= 0 || Vp < V) return cudaErrorInvalidValue;
  dim3 grid((Vp + TV - 1) / TV, (N + TB - 1) / TB);
  lbs_kernel<<<grid, LBS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(betas, rt, dirs, tmpl, weights, out, N,
                                                                          KB, V, Vp);
  return cudaGetLastError();
}
