// Landmark-tiled Schur accumulation for Hopper (sm_90a): the SLAM
// marginalization kernel.
//
// Replaces the Pallas kernels of repro/kernels/marg_schur.py:
//   _normal_kernel (:136, reached from accumulate_normal :197 -> :234):
//       per landmark tile, assemble the normal-equation blocks from the BA
//       residual Jacobians r (K,M,2), jx (K,M,2,6), jl (K,M,2,3):
//         hll = sum_{k,r} jl^T jl (3x3),  hpl = sum_r jx^T jl (K,6,3),
//         bl = sum_{k,r} jl^T r (3),      a = hll + jitter I,
//       then accumulate Y = sum_m G_m a_m^-1 G_m^T (6K x 6K) and
//       y = sum_m G_m a_m^-1 bl_m (6K), with G_m (6K,3) the pose-major stack
//       of hpl (row 6k+i holds hpl[k,m,i,:]);
//   _schur_kernel (:63, reached from accumulate :76 -> :85): the same
//       reduction from assembled g (M,D,3), a (M,3,3), b (M,3).
//
// Bound on an H100 SXM at EDX-CAR (K = 10, M = 64): accumulate_normal reads
// 51,200 B and writes 14,640 B (~20 ns at 3.35 TB/s) and needs ~0.87 MFLOP,
// dominated by the outer products of each landmark into the 1,830 entries of
// Y's upper triangle (Y is symmetric; ~13 ns at 67 TFLOP/s fp32), so its
// bound is the bytes; accumulate reads 49,152 B, bound ~19 ns. Both entries
// are launch- and latency-bound: the whole output is 3,660 floats and every
// landmark adds into all of it. The kernel forms all of Y, not its triangle.
//
// Design (simple and right first): one CTA per call. Phase 1 stages one
// tile of TILE landmarks in shared memory (the raw Jacobian slabs, or the
// given g/a/b), assembles and inverts each landmark's 3x3 block with the
// closed-form adjugate of marg_schur._inv3x3, and forms ga = g a^-1. Phase 2
// gives every thread fixed entries of Y and y, held in registers across all
// tiles, and sums the landmarks in ascending order: no float atomics, so the
// result is the same from run to run. The last tile may be partial.
//
// Built with nvcc's default -fmad=true: products and sums may contract into
// FMAs, so the kernel's sums differ from the plain version's einsums in the
// last bits, and chip_smoke.py holds them to a stated tolerance instead of
// bit equality.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;          // landmarks per shared-memory tile
constexpr int THREADS = 512;
constexpr int MAX_K = 16;         // window poses the kernel takes
constexpr int MAX_D = 6 * MAX_K;  // rows of G
constexpr int PER_THREAD = (MAX_D * MAX_D + THREADS - 1) / THREADS;

// tile scratch after the staged inputs: g, ga (TILE, D, 3), ainv (TILE, 9),
// b (TILE, 3)
__host__ __device__ inline int tile_floats(int D) {
  return TILE * (6 * D + 9 + 3);
}

__host__ __device__ inline int normal_stage_floats(int K) {
  // r (K, TILE, 2), jx (K, TILE, 2, 6), jl (K, TILE, 2, 3)
  return K * TILE * (2 + 12 + 6);
}

__host__ __device__ inline int schur_stage_floats() {
  return TILE * 9;                // a (TILE, 3, 3) as given
}

// closed-form 3x3 inverse by the adjugate, the cofactor formulas of
// marg_schur._inv3x3 (row-major in and out)
__device__ inline void inv3x3(const float* a, float* out) {
  const float c00 = a[4] * a[8] - a[5] * a[7];
  const float c01 = a[2] * a[7] - a[1] * a[8];
  const float c02 = a[1] * a[5] - a[2] * a[4];
  const float c10 = a[5] * a[6] - a[3] * a[8];
  const float c11 = a[0] * a[8] - a[2] * a[6];
  const float c12 = a[2] * a[3] - a[0] * a[5];
  const float c20 = a[3] * a[7] - a[4] * a[6];
  const float c21 = a[1] * a[6] - a[0] * a[7];
  const float c22 = a[0] * a[4] - a[1] * a[3];
  const float det = a[0] * c00 + a[1] * c10 + a[2] * c20;
  out[0] = c00 / det; out[1] = c01 / det; out[2] = c02 / det;
  out[3] = c10 / det; out[4] = c11 / det; out[5] = c12 / det;
  out[6] = c20 / det; out[7] = c21 / det; out[8] = c22 / det;
}

// ga[m] = g[m] (D,3) @ ainv[m] (3,3) for the tile's mt landmarks
__device__ inline void form_ga(const float* g, const float* ainv, float* ga,
                               int mt, int D) {
  for (int i = threadIdx.x; i < mt * D * 3; i += blockDim.x) {
    const int m = i / (D * 3), rem = i % (D * 3), d = rem / 3, j = rem % 3;
    const float* gr = g + (m * D + d) * 3;
    const float* ai = ainv + m * 9;
    ga[i] = gr[0] * ai[j] + gr[1] * ai[3 + j] + gr[2] * ai[6 + j];
  }
}

// Phase 2 for one tile: each thread adds the tile's landmarks, in ascending
// order, into the Y entries it owns (e = tid + s * THREADS) and, for
// tid < D, into y[tid]
__device__ inline void accumulate_tile(const float* g, const float* ga,
                                       const float* b, int mt, int D,
                                       float (&acc)[PER_THREAD],
                                       float& acc_y) {
#pragma unroll
  for (int s = 0; s < PER_THREAD; ++s) {
    const int e = threadIdx.x + s * THREADS;
    if (e < D * D) {
      const int d = e / D, f = e % D;
      float v = acc[s];
      for (int m = 0; m < mt; ++m) {
        const float* x = ga + (m * D + d) * 3;
        const float* z = g + (m * D + f) * 3;
        v += x[0] * z[0] + x[1] * z[1] + x[2] * z[2];
      }
      acc[s] = v;
    }
  }
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    for (int m = 0; m < mt; ++m) {
      const float* x = ga + (m * D + d) * 3;
      const float* z = b + m * 3;
      acc_y += x[0] * z[0] + x[1] * z[1] + x[2] * z[2];
    }
  }
}

__device__ inline void write_out(const float (&acc)[PER_THREAD], float acc_y,
                                 int D, float* Y, float* y) {
#pragma unroll
  for (int s = 0; s < PER_THREAD; ++s) {
    const int e = threadIdx.x + s * THREADS;
    if (e < D * D) Y[e] = acc[s];
  }
  if (threadIdx.x < D) y[threadIdx.x] = acc_y;
}

__global__ void __launch_bounds__(THREADS)
marg_normal_kernel(const float* __restrict__ r_in,
                   const float* __restrict__ jx_in,
                   const float* __restrict__ jl_in, int K, int M,
                   float jitter, float* __restrict__ Y,
                   float* __restrict__ y) {
  extern __shared__ float sm[];
  const int D = 6 * K;
  float* rs = sm;                          // (K, TILE, 2)
  float* jxs = rs + K * TILE * 2;          // (K, TILE, 2, 6)
  float* jls = jxs + K * TILE * 12;        // (K, TILE, 2, 3)
  float* g = jls + K * TILE * 6;           // (TILE, D, 3)
  float* ga = g + TILE * D * 3;            // (TILE, D, 3)
  float* ainv = ga + TILE * D * 3;         // (TILE, 9)
  float* b = ainv + TILE * 9;              // (TILE, 3)
  float* hll = ga;                         // (TILE, 9) before ga exists

  float acc[PER_THREAD];
#pragma unroll
  for (int s = 0; s < PER_THREAD; ++s) acc[s] = 0.f;
  float acc_y = 0.f;

  for (int m0 = 0; m0 < M; m0 += TILE) {
    const int mt = min(TILE, M - m0);
    // stage the tile's slabs: for each pose k the mt landmarks are
    // contiguous in every input
    for (int i = threadIdx.x; i < K * mt * 12; i += blockDim.x) {
      const int k = i / (mt * 12), rem = i % (mt * 12);
      jxs[k * TILE * 12 + rem] = jx_in[((size_t)k * M + m0) * 12 + rem];
    }
    for (int i = threadIdx.x; i < K * mt * 6; i += blockDim.x) {
      const int k = i / (mt * 6), rem = i % (mt * 6);
      jls[k * TILE * 6 + rem] = jl_in[((size_t)k * M + m0) * 6 + rem];
    }
    for (int i = threadIdx.x; i < K * mt * 2; i += blockDim.x) {
      const int k = i / (mt * 2), rem = i % (mt * 2);
      rs[k * TILE * 2 + rem] = r_in[((size_t)k * M + m0) * 2 + rem];
    }
    __syncthreads();
    // g[m][6k+i][j] = hpl[k,m,i,j] = sum_r jx[k,m,r,i] jl[k,m,r,j]
    for (int i = threadIdx.x; i < mt * K * 18; i += blockDim.x) {
      const int m = i / (K * 18), rem = i % (K * 18);
      const int k = rem / 18, ij = rem % 18, p = ij / 3, j = ij % 3;
      const float* x = jxs + (k * TILE + m) * 12;
      const float* l = jls + (k * TILE + m) * 6;
      g[(m * D + 6 * k + p) * 3 + j] = x[p] * l[j] + x[6 + p] * l[3 + j];
    }
    // hll[m][i][j] = sum_{k,r} jl[k,m,r,i] jl[k,m,r,j];
    // b[m][i] = sum_{k,r} jl[k,m,r,i] r[k,m,r]
    for (int i = threadIdx.x; i < mt * 12; i += blockDim.x) {
      const int m = i / 12, q = i % 12;
      float v = 0.f;
      if (q < 9) {
        const int p = q / 3, j = q % 3;
        for (int k = 0; k < K; ++k) {
          const float* l = jls + (k * TILE + m) * 6;
          v += l[p] * l[j] + l[3 + p] * l[3 + j];
        }
        hll[m * 9 + q] = v + (p == j ? jitter : 0.f);
      } else {
        const int p = q - 9;
        for (int k = 0; k < K; ++k) {
          const float* l = jls + (k * TILE + m) * 6;
          const float* rr = rs + (k * TILE + m) * 2;
          v += l[p] * rr[0] + l[3 + p] * rr[1];
        }
        b[m * 3 + p] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < mt) inv3x3(hll + threadIdx.x * 9, ainv + threadIdx.x * 9);
    __syncthreads();
    form_ga(g, ainv, ga, mt, D);
    __syncthreads();
    accumulate_tile(g, ga, b, mt, D, acc, acc_y);
    __syncthreads();                       // before the next tile's staging
  }
  write_out(acc, acc_y, D, Y, y);
}

__global__ void __launch_bounds__(THREADS)
marg_schur_kernel(const float* __restrict__ g_in,
                  const float* __restrict__ a_in,
                  const float* __restrict__ b_in, int D, int M,
                  float* __restrict__ Y, float* __restrict__ y) {
  extern __shared__ float sm[];
  float* as = sm;                          // (TILE, 9)
  float* g = as + TILE * 9;                // (TILE, D, 3)
  float* ga = g + TILE * D * 3;
  float* ainv = ga + TILE * D * 3;
  float* b = ainv + TILE * 9;

  float acc[PER_THREAD];
#pragma unroll
  for (int s = 0; s < PER_THREAD; ++s) acc[s] = 0.f;
  float acc_y = 0.f;

  for (int m0 = 0; m0 < M; m0 += TILE) {
    const int mt = min(TILE, M - m0);
    for (int i = threadIdx.x; i < mt * D * 3; i += blockDim.x)
      g[i] = g_in[(size_t)m0 * D * 3 + i];
    for (int i = threadIdx.x; i < mt * 9; i += blockDim.x)
      as[i] = a_in[(size_t)m0 * 9 + i];
    for (int i = threadIdx.x; i < mt * 3; i += blockDim.x)
      b[i] = b_in[(size_t)m0 * 3 + i];
    __syncthreads();
    if (threadIdx.x < mt) inv3x3(as + threadIdx.x * 9, ainv + threadIdx.x * 9);
    __syncthreads();
    form_ga(g, ainv, ga, mt, D);
    __syncthreads();
    accumulate_tile(g, ga, b, mt, D, acc, acc_y);
    __syncthreads();
  }
  write_out(acc, acc_y, D, Y, y);
}

}  // namespace

extern "C" int marg_max_k() { return MAX_K; }

// Both kernels need at most 58 KB of shared memory (K = 16), above the
// 48 KB a block gets without opting in.
extern "C" int marg_normal_launch(const float* r, const float* jx,
                                  const float* jl, int K, int M, float jitter,
                                  float* Y, float* y, void* stream) {
  const int smem =
      (int)sizeof(float) * (normal_stage_floats(K) + tile_floats(6 * K));
  int err = (int)cudaFuncSetAttribute(
      marg_normal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  marg_normal_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      r, jx, jl, K, M, jitter, Y, y);
  return (int)cudaGetLastError();
}

extern "C" int marg_schur_launch(const float* g, const float* a,
                                 const float* b, int D, int M, float* Y,
                                 float* y, void* stream) {
  const int smem = (int)sizeof(float) * (schur_stage_floats() + tile_floats(D));
  int err = (int)cudaFuncSetAttribute(
      marg_schur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  marg_schur_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      g, a, b, D, M, Y, y);
  return (int)cudaGetLastError();
}
