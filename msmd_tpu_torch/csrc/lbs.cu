// Fused FLAME vertex decode (blendshapes + 5-joint linear blend skinning),
// hand-written for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes).
//
// Replaces the forward of the TPU kernel msmd_tpu/ops/pallas/lbs_kernel.py::
// flame_vertices_fused (_fused_skin -> _lbs_kernel). For every frame n and
// vertex v:
//   p_c    = template_c[v] + sum_k betas_ext[n, k] * dirs[c, k, v]   (c = x, y, z)
//   out_d  = sum_j W[j, v] * (R_j[d, :] . p + t_j[d])
// with rt[n] holding the five joints' [R | t] rows. The per-vertex
// transforms and the posed-vertex planes never reach device memory; the
// kernel writes (N, V, 3) directly.
//
// What bounds it on an H100 SXM: at N = 4800 frames (batch 48 x 100), V =
// 5023 and KB = 186 basis rows the blend product is 26.9 GFLOP, the
// skinning 3.3 GFLOP (f32, 0.049 ms at 67 TFLOP/s) and the bytes ~305 MB,
// 289 MB of them the output (0.091 ms at 3.35 TB/s). The output is held to
// f32 accuracy (max |err| <= 1e-5 against the f32 plain version), which one
// TF32 product misses: TF32 keeps 10 mantissa bits, so each of the 186
// terms of ~3e-3 is off by up to 2^-11 of itself, ~5e-5 at the largest of
// the 72 M outputs (tests/test_torch_lbs_plan.py emulates it). So the
// product runs as three TF32 products on the tensor cores (3xTF32): each
// operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and
// lo.hi + hi.lo + hi.hi (the dropped lo.lo is below 2^-22 of a term) is
// summed in the f32 accumulator. That is 3 x 26.9 GFLOP at 495 TFLOP/s:
// 0.163 ms, the bound (by operations). On the f32 CUDA cores the same
// work is bounded at 0.450 ms.
//
// Design:
// - Two launches. lbs_split_kernel splits betas_ext (N x KB, a row of 744
//   bytes, which TMA cannot address) into hi and lo planes (2 x N x KBP,
//   KB padded with zeros to KBP, a multiple of 16). The bases' planes are
//   constant: FusedFlame (ops/kernels/lbs.py) makes them once, K-major
//   (3, Vp, KBP), since wgmma reads TF32 operands K-major only.
// - lbs_kernel: a persistent grid (the plan's, one 256-thread block an SM)
//   walks tiles of 128 frames x 64 vertices, frames fastest. The two
//   warpgroups hold 64 frames each; a warpgroup's wgmma is m64n192 (96
//   accumulators a thread) with B laid out as [x(v0 : v0+64) | y | z], so
//   the accumulator layout gives the thread that holds column j also
//   columns j + 64 and j + 128: the x, y and z of one vertex and frame.
//   Narrower tiles cost more L2 bytes a flop than they win, at N = 4800
//   and at batch 1 alike (PERF.md, section 6).
// - One elected thread issues TMA copies into a ring of LBS_STAGES
//   16-deep k-steps (64-byte rows, the 64-byte swizzle wgmma's descriptors
//   read): A hi and lo (128 x 16 each) and B hi and lo (192 x 16 each).
//   Per k-step each warpgroup runs 2 x 3 wgmma m64n192k8 and keeps one
//   group in flight; the ring runs on across a block's tiles, so the next
//   tile's first k-steps load while this one's epilogue runs. At a tile's
//   first k-step the same thread also copies the tile's 128 rt rows, its
//   vertices' weights and template into shared memory.
// - Epilogue in registers: the skinning of each thread's 2 frames x 16
//   vertices, then each warp stages 8 rows x 32 vertices of outputs in
//   shared memory and writes every row as consecutive 4-byte stores across
//   the warp (a row of the tile is 192 contiguous floats of (N, V, 3)),
//   all reads before the stores. Rows past N and vertices past V are not
//   written; TMA zero-fills the operands past them. The epilogue does not
//   overlap the tensor cores, though it is over 40% of the kernel's time:
//   every overlap tried (the accumulators handed to other warps through
//   shared memory, the epilogue in pieces between the next tile's k-steps)
//   slowed the TF32 main loop more than it hid (PERF.md, section 6).
// Every output sums its terms in the same order whatever block computes
// it, so two calls give the same bits.

#include "decoder_common.cuh"

namespace {

constexpr int LBS_THREADS = 256;  // two warpgroups
constexpr int LBS_BM = 128;       // frames a tile
constexpr int LBS_VW = 64;        // vertices a tile
constexpr int LBS_BK = 16;        // basis rows a k-step: one 64-byte row of f32
constexpr int LBS_STAGES = 4;
constexpr int NJ = 5, RT = NJ * 12;
constexpr int LBS_CHUNK = 32;               // vertices a warp stages and stores at a time
constexpr int LBS_STG = 3 * LBS_CHUNK + 1;  // a staged output row, padded

struct LbsTile {
  static constexpr int N = 3 * LBS_VW;                      // wgmma n: [x | y | z]
  static constexpr int ACC = N / 2;                         // accumulators a thread
  static constexpr int A_PLANE = LBS_BM * LBS_BK * 4;       // 8 KB
  static constexpr int B_BOX = N * LBS_BK * 4;              // bytes TMA writes per B plane
  static constexpr int B_PLANE = (B_BOX + 1023) / 1024 * 1024;
  static constexpr int STAGE = 2 * A_PLANE + 2 * B_PLANE;
  static constexpr int TX = 2 * A_PLANE + 2 * B_BOX;        // bytes a stage's copies complete
  // the epilogue's inputs for a tile: rt [128 frames][60], weights [5][LBS_VW],
  // template [3][LBS_VW]
  static constexpr int W_OFF = LBS_BM * RT * 4, T_OFF = W_OFF + NJ * LBS_VW * 4, EPI = T_OFF + 3 * LBS_VW * 4;
  static constexpr int EPI_TX = LBS_BM * RT * 4 + 8 * LBS_VW * 4;
  static constexpr size_t SMEM = (size_t)LBS_STAGES * STAGE + EPI + 8 * 8 * LBS_STG * sizeof(float) +
                                 (LBS_STAGES + 1) * sizeof(uint64_t) + 1024;
};

struct LbsMaps {
  CUtensorMap a, bhi, blo;  // A (KBP, N, 2 planes); B hi, lo (KBP, Vp, 3)
  CUtensorMap rt, w, t;     // rt (60, N), weights (Vp, 5), template (Vp, 3)
};

struct LbsArgs {
  float* out;            // N x V x 3
  int N, V, Vp, KBP;
  long long* stamps;     // null, or per block: main-loop, epilogue and whole ns
};

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wgmma descriptor of a K-major operand in the 64-byte swizzle: 8-row
// groups 512 bytes apart
__device__ __forceinline__ uint64_t lbs_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// d (64 x 192 f32 of this warpgroup) += A (64 x 8 tf32) B (8 x 192 tf32), both K-major in
// shared memory
__device__ __forceinline__ void wgmma_m64n192k8_tf32(float (&d)[96], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// betas_ext (N x KB) -> hi and lo planes (2 x N x KBP), zero past KB
__global__ void lbs_split_kernel(const float* __restrict__ betas, float* __restrict__ ws, int N, int KB, int KBP) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)N * KBP) return;
  const int n = static_cast<int>(i / KBP), k = static_cast<int>(i % KBP);
  const float x = k < KB ? betas[(long)n * KB + k] : 0.0f;
  const float hi = tf32_rna(x);
  ws[i] = hi;
  ws[(long)N * KBP + i] = tf32_rna(x - hi);
}

// The skinning of one tile's accumulators and its stores. d[4B + 2h + e]
// is row 8h + lane / 4 of this warp's 16, column 8B + 2 (lane % 4) + e;
// blocks B < LBS_VW / 8 are x, then y, then z of the same vertices. rts, ws
// and ts are the tile's rt rows, weights and template in shared memory;
// stg is this warp's staging buffer (8 rows of LBS_STG). Plain stores: the
// streaming st.global.cs ran slower (PERF.md, section 6).
__device__ __forceinline__ void lbs_epilogue(const LbsArgs& g, const float (&d)[LbsTile::ACC], int f0, int v0,
                                             const float* rts, const float* ws, const float* ts, float* stg) {
  const int tid = threadIdx.x, lane = tid % 32, q = lane % 4;
  const int wrow = (tid / 128) * 64 + ((tid % 128) / 32) * 16;  // this warp's first row in the tile
  const int nv = g.V - v0 < LBS_VW ? g.V - v0 : LBS_VW;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float R[RT];
    const float4* src = reinterpret_cast<const float4*>(rts + (wrow + 8 * h + lane / 4) * RT);
#pragma unroll
    for (int i = 0; i < RT / 4; ++i) {
      const float4 r = src[i];
      R[4 * i] = r.x;
      R[4 * i + 1] = r.y;
      R[4 * i + 2] = r.z;
      R[4 * i + 3] = r.w;
    }
#pragma unroll
    for (int cb = 0; cb < LBS_VW / 8; cb += LBS_CHUNK / 8) {
#pragma unroll
      for (int b = cb; b < cb + LBS_CHUNK / 8 && b < LBS_VW / 8; ++b) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int vl = 8 * b + 2 * q + e;
          const float px = d[4 * b + 2 * h + e] + ts[vl];
          const float py = d[4 * (LBS_VW / 8 + b) + 2 * h + e] + ts[LBS_VW + vl];
          const float pz = d[4 * (2 * LBS_VW / 8 + b) + 2 * h + e] + ts[2 * LBS_VW + vl];
          float ox = 0.0f, oy = 0.0f, oz = 0.0f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float w = ws[j * LBS_VW + vl];
            const float* r = R + 12 * j;
            ox += w * (r[0] * px + r[1] * py + r[2] * pz + r[3]);
            oy += w * (r[4] * px + r[5] * py + r[6] * pz + r[7]);
            oz += w * (r[8] * px + r[9] * py + r[10] * pz + r[11]);
          }
          float* s = stg + (lane / 4) * LBS_STG + 3 * (vl - 8 * cb);
          s[0] = ox;
          s[1] = oy;
          s[2] = oz;
        }
      }
      __syncwarp();
      // the warp's 8 rows x 3 LBS_CHUNK values: every read first, then the
      // stores, so no store waits on its read
      const int left = nv - 8 * cb, cnt = 3 * (left < LBS_CHUNK ? (left > 0 ? left : 0) : LBS_CHUNK);
      float val[8][3 * LBS_CHUNK / 32];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < 3 * LBS_CHUNK / 32; ++u) val[i][u] = stg[i * LBS_STG + lane + 32 * u];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int f = f0 + wrow + 8 * h + i;
        if (f < g.N) {
          float* o = g.out + ((long)f * g.V + v0 + 8 * cb) * 3;
#pragma unroll
          for (int u = 0; u < 3 * LBS_CHUNK / 32; ++u)
            if (lane + 32 * u < cnt) o[lane + 32 * u] = val[i][u];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(LBS_THREADS, 1) lbs_kernel(const __grid_constant__ LbsMaps maps, const LbsArgs g) {
  using T = LbsTile;
  extern __shared__ __align__(128) unsigned char lbs_smem[];
  const uint32_t raw = smem_u32(lbs_smem);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* sm = lbs_smem + pad;  // the ring, aligned to 1024 bytes
  const uint32_t s0 = raw + pad;
  unsigned char* epi = sm + LBS_STAGES * T::STAGE;
  const float* rts = reinterpret_cast<const float*>(epi);
  float* stg = reinterpret_cast<float*>(epi + T::EPI);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + 8 * 8 * LBS_STG);
  uint64_t* epi_full = full + LBS_STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int tf = (g.N + LBS_BM - 1) / LBS_BM, n = tf * ((g.V + LBS_VW - 1) / LBS_VW), KT = g.KBP / LBS_BK;
  const long long t_start = g.stamps ? global_ns() : 0;
  long long t_main = 0, t_epi = 0;
  if (tid == 0) {
    for (int s = 0; s < LBS_STAGES + 1; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // by the elected thread: this block's k-iteration j (its tile j / KT,
  // k-step j % KT) into stage j % LBS_STAGES, if that tile exists; tiles
  // run frames fastest, so the blocks in flight share B
  auto load = [&](int j) {
    const int t = blockIdx.x + (j / KT) * gridDim.x;
    if (t >= n) return;
    const int k0 = (j % KT) * LBS_BK, s = j % LBS_STAGES, f0 = (t % tf) * LBS_BM, v0 = (t / tf) * LBS_VW;
    unsigned char* st = sm + s * T::STAGE;
    mbar_expect_tx(&full[s], T::TX);
    tma_load(st, &maps.a, &full[s], k0, f0, 0);
    tma_load(st + T::A_PLANE, &maps.a, &full[s], k0, f0, 1);
    tma_load(st + 2 * T::A_PLANE, &maps.bhi, &full[s], k0, v0, 0);
    tma_load(st + 2 * T::A_PLANE + T::B_PLANE, &maps.blo, &full[s], k0, v0, 0);
  };
  if (tid == 0)
    for (int j = 0; j < LBS_STAGES - 1; ++j) load(j);

  int it = 0, tc = 0;  // this block's k-iterations and tiles so far
  for (int t = blockIdx.x; t < n; t += gridDim.x, ++tc) {
    const int f0 = (t % tf) * LBS_BM, v0 = (t / tf) * LBS_VW;
    const long long t0 = g.stamps ? global_ns() : 0;
    float d[T::ACC];
#pragma unroll
    for (int i = 0; i < T::ACC; ++i) d[i] = 0.0f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % LBS_STAGES;
      mbar_wait(&full[s], (it / LBS_STAGES) & 1);
      const uint32_t ahi = s0 + s * T::STAGE + wg * (T::A_PLANE / 2), alo = ahi + T::A_PLANE;
      const uint32_t bhi = s0 + s * T::STAGE + 2 * T::A_PLANE, blo = bhi + T::B_PLANE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < LBS_BK / 8; ++kk) {
        // k advanced 32 bytes inside the swizzled 64-byte row; the small
        // terms first
        wgmma_m64n192k8_tf32(d, lbs_desc(alo + kk * 32), lbs_desc(bhi + kk * 32));
        wgmma_m64n192k8_tf32(d, lbs_desc(ahi + kk * 32), lbs_desc(blo + kk * 32));
        wgmma_m64n192k8_tf32(d, lbs_desc(ahi + kk * 32), lbs_desc(bhi + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<1>();  // this warpgroup's previous group is done
      __syncthreads();  // ... and the other's: the stage it read is free
      if (tid == 0) {
        load(it + LBS_STAGES - 1);
        if (kt == 0) {
          // the epilogue's inputs, behind the last tile's epilogue (every
          // thread has passed the barrier above since)
          mbar_expect_tx(epi_full, T::EPI_TX);
          tma_load(epi, &maps.rt, epi_full, 0, f0, 0);
          tma_load(epi + T::W_OFF, &maps.w, epi_full, v0, 0, 0);
          tma_load(epi + T::T_OFF, &maps.t, epi_full, v0, 0, 0);
        }
      }
    }
    wgmma_wait<0>();
    const long long t1 = g.stamps ? global_ns() : 0;
    mbar_wait(epi_full, tc & 1);
    lbs_epilogue(g, d, f0, v0, rts, reinterpret_cast<const float*>(epi + T::W_OFF),
                     reinterpret_cast<const float*>(epi + T::T_OFF), stg + (tid / 32) * 8 * LBS_STG);
    if (g.stamps) {
      __syncthreads();
      t_main += t1 - t0;
      t_epi += global_ns() - t1;
    }
  }
  __syncthreads();  // every wait on the barriers is done
  if (tid == 0) {
    for (int s = 0; s < LBS_STAGES + 1; ++s) mbar_inval(&full[s]);
    if (g.stamps) {
      g.stamps[3 * blockIdx.x] = t_main;
      g.stamps[3 * blockIdx.x + 1] = t_epi;
      g.stamps[3 * blockIdx.x + 2] = global_ns() - t_start;
    }
  }
}

// An f32 tensor (d0 innermost, then d1, then d2, row stride ld0 elements,
// plane stride ld1) as a tensor map of boxes box0 x box1 x box2, in the
// 64-byte swizzle (the product's operands) or none; out-of-range elements
// read as zero.
cudaError_t lbs_map(CUtensorMap* map, const float* base, long d0, long d1, long d2, long ld0, long ld1, int box0,
                    int box1, int box2, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)ld0 * sizeof(float), (cuuint64_t)ld1 * sizeof(float)};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, (cuuint32_t)box2}, unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t lbs_launch(cudaStream_t st, const LbsMaps& maps, const LbsArgs& g, int grid) {
  static bool attr_set = false;
  if (!attr_set) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(lbs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(LbsTile::SMEM)));
    attr_set = true;
  }
  lbs_kernel<<<grid, LBS_THREADS, LbsTile::SMEM, st>>>(maps, g);
  return cudaGetLastError();
}

}  // namespace

// betas (N, KB), rt (N, 60), dirs_hi and dirs_lo (3, Vp, KBP: the bases'
// TF32 planes, K-major), tmpl (3, Vp), weights (5, Vp), ws (2, N, KBP)
// scratch, out (N, V, 3); all f32, contiguous, 16-byte aligned. grid comes
// from ops/kernels/lbs.py::lbs_plan. stamps: null, or
// grid x 3 int64 (each block's main-loop, epilogue and whole ns, the
// epilogue then ending in a block barrier). Launches lbs_split_kernel and
// lbs_kernel on `stream`; returns the first CUDA error or 0.
extern "C" int msmd_lbs_forward(const float* betas, const float* rt, const float* dirs_hi, const float* dirs_lo,
                                const float* tmpl, const float* weights, float* ws, float* out, int N, int KB, int KBP,
                                int V, int Vp, int grid, long long* stamps, void* stream) {
  if (N <= 0 || V <= 0 || Vp < V || KB <= 0 || KBP < KB || KBP % LBS_BK != 0 || grid <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LbsMaps maps;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_64B, NONE = CU_TENSOR_MAP_SWIZZLE_NONE;
  RETURN_IF_ERROR(lbs_map(&maps.a, ws, KBP, N, 2, KBP, (long)N * KBP, LBS_BK, LBS_BM, 1, SW));
  RETURN_IF_ERROR(lbs_map(&maps.bhi, dirs_hi, KBP, Vp, 3, KBP, (long)Vp * KBP, LBS_BK, LBS_VW, 3, SW));
  RETURN_IF_ERROR(lbs_map(&maps.blo, dirs_lo, KBP, Vp, 3, KBP, (long)Vp * KBP, LBS_BK, LBS_VW, 3, SW));
  RETURN_IF_ERROR(lbs_map(&maps.rt, rt, RT, N, 1, RT, (long)N * RT, RT, LBS_BM, 1, NONE));
  RETURN_IF_ERROR(lbs_map(&maps.w, weights, Vp, NJ, 1, Vp, (long)NJ * Vp, LBS_VW, NJ, 1, NONE));
  RETURN_IF_ERROR(lbs_map(&maps.t, tmpl, Vp, 3, 1, Vp, 3L * Vp, LBS_VW, 3, 1, NONE));
  const long n = (long)N * KBP;
  lbs_split_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(betas, ws, N, KB, KBP);
  RETURN_IF_ERROR(cudaGetLastError());
  const LbsArgs g{out, N, V, Vp, KBP, stamps};
  return lbs_launch(st, maps, g, grid);
}
