// Fused IMU covariance sweep for Hopper (sm_90a).
//
// Replaces the Pallas kernel _cov_kernel of repro/kernels/cov_update.py:64
// (reached from fused_update, cov_update.py:87): K sequential IMU
// transitions on the 15-row block of the error covariance
// (Pii <- sym(F Pii F^T + Q), Pic <- F Pic, Pci <- Pic^T), gated by
// do_prop, then the clone-window permutation and new-clone insertion of
// _augment_P (cov_update.py:48).
//
// Bound on an H100 SXM: one read and one write of P. At EDX-CAR
// (window 30, d = 195) that is 2 x 152,100 B = 0.3 MB, ~0.09 us at
// 3.35 TB/s; the K x (15 x 15 x d) products are ~0.6 MFLOP. The sweep is
// a chain of K dependent steps, so it is latency-bound.
// Design: one CTA keeps all of P in dynamic shared memory (opted in above
// the 48 KB static limit) for the whole sweep, so device memory sees one
// read and one write of P. The permutation + insertion is pure copying and
// is folded into the final write-back.
#include <cuda_runtime.h>

namespace {

constexpr int NI = 15;          // IMU error-state block
constexpr int COV_THREADS = 512;

__host__ __device__ inline size_t cov_smem_floats(int d) {
  // P, F, Q, F*Pii, F*Pii*F^T + Q, F*Pic
  return (size_t)d * d + 4 * NI * NI + (size_t)NI * (d - NI);
}

__global__ void cov_update_kernel(const float* __restrict__ P_in,
                                  const float* __restrict__ F_seq,
                                  const float* __restrict__ Q_in,
                                  const int* __restrict__ gate, int d, int K,
                                  float* __restrict__ P_out) {
  extern __shared__ float sm[];
  float* P = sm;
  float* F = P + d * d;
  float* Q = F + NI * NI;
  float* T = Q + NI * NI;
  float* U = T + NI * NI;
  float* N = U + NI * NI;
  const int nc = d - NI;
  const int tid = threadIdx.x;

  for (int i = tid; i < d * d; i += blockDim.x) P[i] = P_in[i];
  for (int i = tid; i < NI * NI; i += blockDim.x) Q[i] = Q_in[i];
  __syncthreads();

  if (gate[0] > 0) {
    for (int k = 0; k < K; ++k) {
      for (int i = tid; i < NI * NI; i += blockDim.x) F[i] = F_seq[k * NI * NI + i];
      __syncthreads();
      // T = F Pii (15 x 15) and N = F Pic (15 x (d-15)) from the old P
      for (int i = tid; i < NI * d; i += blockDim.x) {
        const int r = i / d, c = i % d;
        float acc = 0.f;
        for (int m = 0; m < NI; ++m) acc += F[r * NI + m] * P[m * d + c];
        if (c < NI) T[r * NI + c] = acc;
        else N[r * nc + c - NI] = acc;
      }
      __syncthreads();
      // U = T F^T + Q
      for (int i = tid; i < NI * NI; i += blockDim.x) {
        const int r = i / NI, c = i % NI;
        float acc = 0.f;
        for (int m = 0; m < NI; ++m) acc += T[r * NI + m] * F[c * NI + m];
        U[i] = acc + Q[i];
      }
      __syncthreads();
      for (int i = tid; i < NI * NI; i += blockDim.x) {
        const int r = i / NI, c = i % NI;
        P[r * d + c] = 0.5f * (U[r * NI + c] + U[c * NI + r]);
      }
      for (int i = tid; i < NI * nc; i += blockDim.x) {
        const int r = i / nc, c = i % nc;
        P[r * d + NI + c] = N[i];
        P[(NI + c) * d + r] = N[i];
      }
      __syncthreads();
    }
  }

  // augment: P_shift = P[keep][:, keep] with keep = [0..14, 21..d-1,
  // 15..20] (oldest clone moved to the end), then the last clone's rows
  // and columns become copies of P_shift's first 6 (the new clone = the
  // current pose)
  const int e = d - 6;
  for (int i = tid; i < d * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    int a, b;
    if (r < e && c < e) { a = r; b = c; }
    else if (r < e) { a = r; b = c - e; }
    else if (c < e) { a = c; b = r - e; }
    else { a = r - e; b = c - e; }
    const int ka = a < NI ? a : (a < e ? a + 6 : a - (d - 21));
    const int kb = b < NI ? b : (b < e ? b + 6 : b - (d - 21));
    P_out[i] = P[ka * d + kb];
  }
}

}  // namespace

extern "C" int cov_update_smem_bytes(int d) {
  return (int)(sizeof(float) * cov_smem_floats(d));
}

extern "C" int cov_update_launch(const float* P, const float* F_seq, const float* Q,
                                 const int* gate, int d, int K, float* out,
                                 void* stream) {
  const int smem = cov_update_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      cov_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cov_update_kernel<<<1, COV_THREADS, smem, (cudaStream_t)stream>>>(
      P, F_seq, Q, gate, d, K, out);
  return (int)cudaGetLastError();
}
