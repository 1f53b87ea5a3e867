// Fused frontend kernels A, B and C for Hopper (sm_90a).
//
// Replace the Pallas kernels of repro/kernels/frontend_fused.py:
//   kernel A  fe_detect_kernel   <- _fe_kernel  (frontend_fused.py:117)
//   kernel B  fc_describe_kernel <- _fc_kernel  (frontend_fused.py:240)
//   kernel C  mo_match_kernel    <- _mo_kernel  (frontend_fused.py:290)
//
// Bounds on an H100 SXM (3.35 TB/s):
//   A  per 720x1280 image reads 3.69 MB and writes 3.69 MB (smooth) plus
//      0.12 MB (cell maxima + indices): ~2.3 us per image, memory-bound.
//      Design: one block per 8-row NMS strip of 128 columns; the raw tile
//      with its clamped halo is loaded into shared memory once and feeds
//      the vertical blur, the horizontal blur and the FAST ring, so the
//      padded frame and the dense score map never exist in device memory
//      (border clamping replaces jnp.pad(mode="edge")).
//   B  per image writes 512 x (256 B + 32 B) = 150 KB and gathers from the
//      smoothed frame, which sits in L2: latency-bound. Design: one block
//      per corner, one thread per disc sample and per BRIEF pair, a warp
//      ballot packs 32 bits into a word.
//   C  512 x 512 x 8 XOR+popcount (~2 M popcounts): launch-bound. Design:
//      one thread per left descriptor, first-index argmin.
//
// Float order: every product and sum that feeds a comparison (blur, FAST
// score, bilinear weights, orientation moments) is written with
// __fmul_rn/__fadd_rn/__fsub_rn, so nvcc cannot contract it into an FMA,
// and is taken in the order of the plain PyTorch version. atan2f, sinf and
// cosf are the accurate library functions (no --use_fast_math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TAPS = 17;
constexpr int A_TILE_W = 128;   // columns per kernel-A block
constexpr int A_THREADS = 256;
constexpr int MARGIN = 16;      // corners this close to the border score 0

struct Taps {
  float t[MAX_TAPS];
  int n;
};

// FAST-16 ring (dy, dx), clockwise: repro/core/frontend/fast.py CIRCLE
__constant__ int RING[16][2] = {
    {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}, {0, 3}, {1, 3}, {2, 2}, {3, 1},
    {3, 0}, {3, -1}, {2, -2}, {1, -3}, {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool has_arc(unsigned mask, int arc_len) {
  for (int start = 0; start < 16; ++start) {
    bool run = true;
    for (int j = 0; j < arc_len; ++j) run = run && ((mask >> ((start + j) & 15)) & 1u);
    if (run) return true;
  }
  return false;
}

// kernel A: blur + FAST-9 + per-cell argmax over one (cell x 128) strip
__global__ void fe_detect_kernel(const float* __restrict__ img, int H, int W,
                                 Taps taps, float thr, int arc_len, int cell,
                                 int halo, float* __restrict__ smooth,
                                 float* __restrict__ best,
                                 int* __restrict__ idx) {
  extern __shared__ float sm[];
  const int R = taps.n / 2;
  const int y0 = blockIdx.y * cell;
  const int x0 = blockIdx.x * A_TILE_W;
  const int tw = min(A_TILE_W, W - x0);
  const int RW = A_TILE_W + 2 * halo;   // shared row stride
  const int RR = cell + 2 * halo;       // raw rows incl. halo
  float* raw = sm;                      // (RR, RW)   raw pixels
  float* vb = raw + RR * RW;            // (cell, RW) vertical blur
  float* sc = vb + cell * RW;           // (cell, A_TILE_W) FAST score

  for (int i = threadIdx.x; i < RR * RW; i += blockDim.x) {
    const int r = i / RW, c = i % RW;
    raw[i] = img[clampi(y0 - halo + r, 0, H - 1) * W +
                 clampi(x0 - halo + c, 0, W - 1)];
  }
  __syncthreads();

  // vertical pass, summed in tap order from zero
  for (int i = threadIdx.x; i < cell * RW; i += blockDim.x) {
    const int r = i / RW, c = i % RW;
    float acc = 0.f;
    for (int t = 0; t < taps.n; ++t)
      acc = __fadd_rn(acc, __fmul_rn(raw[(r + halo - R + t) * RW + c], taps.t[t]));
    vb[i] = acc;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cell * A_TILE_W; i += blockDim.x) {
    const int r = i / A_TILE_W, c = i % A_TILE_W;
    if (c >= tw) continue;
    // horizontal pass
    float acc = 0.f;
    for (int t = 0; t < taps.n; ++t)
      acc = __fadd_rn(acc, __fmul_rn(vb[r * RW + c + halo - R + t], taps.t[t]));
    smooth[(y0 + r) * W + x0 + c] = acc;

    // FAST-9 on the raw pixels
    const float ctr = raw[(r + halo) * RW + c + halo];
    float diff[16];
    unsigned bm = 0u, dm = 0u;
    for (int k = 0; k < 16; ++k) {
      diff[k] = __fsub_rn(raw[(r + halo + RING[k][0]) * RW + c + halo + RING[k][1]], ctr);
      if (diff[k] > thr) bm |= 1u << k;
      if (diff[k] < -thr) dm |= 1u << k;
    }
    float sb = 0.f, sd = 0.f;
    for (int k = 0; k < 16; ++k) {
      const float ex = __fsub_rn(fabsf(diff[k]), thr);
      sb = __fadd_rn(sb, ((bm >> k) & 1u) ? ex : 0.f);
      sd = __fadd_rn(sd, ((dm >> k) & 1u) ? ex : 0.f);
    }
    float score = __fadd_rn(has_arc(bm, arc_len) ? sb : 0.f,
                            has_arc(dm, arc_len) ? sd : 0.f);
    const int yy = y0 + r, xx = x0 + c;
    if (!(yy >= MARGIN && yy < H - MARGIN && xx >= MARGIN && xx < W - MARGIN))
      score = 0.f;
    sc[i] = score;
  }
  __syncthreads();

  // per-cell argmax, first maximum wins (jnp.argmax / torch.argmax)
  const int Wc = W / cell;
  for (int k = threadIdx.x; k < tw / cell; k += blockDim.x) {
    float bv = sc[k * cell];
    int bi = 0;
    for (int dy = 0; dy < cell; ++dy)
      for (int dx = 0; dx < cell; ++dx) {
        const float v = sc[dy * A_TILE_W + k * cell + dx];
        if (v > bv) { bv = v; bi = dy * cell + dx; }
      }
    const int o = blockIdx.y * Wc + x0 / cell + k;
    best[o] = bv;
    idx[o] = bi;
  }
}

// bilinear sample, clipped to [0, ymax] x [0, xmax] (orb._bilinear)
__device__ __forceinline__ float bilinear(const float* __restrict__ img, int W,
                                          float y, float x, float ymax, float xmax) {
  y = fminf(fmaxf(y, 0.f), ymax);
  x = fminf(fmaxf(x, 0.f), xmax);
  const int iy = (int)floorf(y), ix = (int)floorf(x);
  const float dy = __fsub_rn(y, (float)iy), dx = __fsub_rn(x, (float)ix);
  const float* p = img + iy * W + ix;
  const float ody = __fsub_rn(1.f, dy), odx = __fsub_rn(1.f, dx);
  float v = __fmul_rn(__fmul_rn(p[0], ody), odx);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(p[1], ody), dx));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(p[W], dy), odx));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(p[W + 1], dy), dx));
  return v;
}

// kernel B: orientation + rotated BRIEF + packing, one block per corner
__global__ void fc_describe_kernel(const float* __restrict__ img, int H, int W,
                                   const int* __restrict__ yx,
                                   const float* __restrict__ cdy,
                                   const float* __restrict__ cdx, int nc,
                                   const float* __restrict__ pairs, float ymax,
                                   float xmax, uint8_t* __restrict__ desc,
                                   uint32_t* __restrict__ packed) {
  extern __shared__ float sm[];
  float* p01 = sm;          // (nc,) v * dy
  float* p10 = sm + nc;     // (nc,) v * dx
  float* cs = p10 + nc;     // cos, sin of the angle
  const int n = blockIdx.x, t = threadIdx.x, nbits = blockDim.x;
  const float fy = (float)yx[2 * n], fx = (float)yx[2 * n + 1];

  for (int k = t; k < nc; k += nbits) {
    const float dy = cdy[k], dx = cdx[k];
    const float v = bilinear(img, W, __fadd_rn(fy, dy), __fadd_rn(fx, dx), ymax, xmax);
    p01[k] = __fmul_rn(v, dy);
    p10[k] = __fmul_rn(v, dx);
  }
  __syncthreads();
  if (t == 0) {
    float m01 = 0.f, m10 = 0.f;
    for (int k = 0; k < nc; ++k) {       // table order, as the plain version
      m01 = __fadd_rn(m01, p01[k]);
      m10 = __fadd_rn(m10, p10[k]);
    }
    const float a = atan2f(m01, m10);
    cs[0] = cosf(a);
    cs[1] = sinf(a);
  }
  __syncthreads();
  const float c = cs[0], s = cs[1];
  const float* pr = pairs + 4 * t;
  const float y1 = __fsub_rn(__fmul_rn(pr[0], c), __fmul_rn(pr[1], s));
  const float x1 = __fadd_rn(__fmul_rn(pr[0], s), __fmul_rn(pr[1], c));
  const float y2 = __fsub_rn(__fmul_rn(pr[2], c), __fmul_rn(pr[3], s));
  const float x2 = __fadd_rn(__fmul_rn(pr[2], s), __fmul_rn(pr[3], c));
  const float v1 = bilinear(img, W, __fadd_rn(fy, y1), __fadd_rn(fx, x1), ymax, xmax);
  const float v2 = bilinear(img, W, __fadd_rn(fy, y2), __fadd_rn(fx, x2), ymax, xmax);
  const bool bit = v1 < v2;
  desc[n * nbits + t] = bit ? 1 : 0;
  // bit j of word w is desc[32w + j]: lane j of warp w
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if ((t & 31) == 0) packed[n * (nbits / 32) + t / 32] = word;
}

// kernel C: epipolar-masked hamming match, one thread per left descriptor
__global__ void mo_match_kernel(const uint32_t* __restrict__ pkl,
                                const int* __restrict__ yxl,
                                const uint8_t* __restrict__ vl,
                                const uint32_t* __restrict__ pkr,
                                const int* __restrict__ yxr,
                                const uint8_t* __restrict__ vr, int NL, int NR,
                                int max_disp, int row_tol, int* __restrict__ out_idx,
                                int* __restrict__ out_best,
                                float* __restrict__ out_disp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NL) return;
  uint32_t a[8];
  for (int w = 0; w < 8; ++w) a[w] = pkl[8 * i + w];
  const int yl = yxl[2 * i], xl = yxl[2 * i + 1];
  const bool okl = vl[i] != 0;
  int bd = 0x7fffffff, bi = 0;
  for (int j = 0; j < NR; ++j) {
    const int dr = yl - yxr[2 * j], disp = xl - yxr[2 * j + 1];
    const bool ok = okl && vr[j] != 0 && (dr < 0 ? -dr : dr) <= row_tol &&
                    disp >= 0 && disp <= max_disp;
    int d = 1 << 30;
    if (ok) {
      d = 0;
      for (int w = 0; w < 8; ++w) d += __popc(a[w] ^ pkr[8 * j + w]);
    }
    if (d < bd) { bd = d; bi = j; }
  }
  out_idx[i] = bi;
  out_best[i] = bd;
  out_disp[i] = (float)(xl - yxr[2 * bi + 1]);
}

}  // namespace

extern "C" int fe_detect_launch(const float* img, int H, int W, const float* taps,
                                int ntaps, float thr, int arc_len, int cell,
                                float* smooth, float* best, int* idx, void* stream) {
  if (ntaps > MAX_TAPS) return (int)cudaErrorInvalidValue;
  Taps tp;
  for (int i = 0; i < ntaps; ++i) tp.t[i] = taps[i];
  tp.n = ntaps;
  const int R = ntaps / 2;
  const int halo = R > 3 ? R : 3;
  const int RW = A_TILE_W + 2 * halo;
  const size_t smem = sizeof(float) *
      ((size_t)(cell + 2 * halo) * RW + (size_t)cell * RW + (size_t)cell * A_TILE_W);
  dim3 grid((W + A_TILE_W - 1) / A_TILE_W, H / cell);
  fe_detect_kernel<<<grid, A_THREADS, smem, (cudaStream_t)stream>>>(
      img, H, W, tp, thr, arc_len, cell, halo, smooth, best, idx);
  return (int)cudaGetLastError();
}

extern "C" int fc_describe_launch(const float* smooth, int H, int W, const int* yx,
                                  int N, const float* cdy, const float* cdx, int nc,
                                  const float* pairs, int nbits, float ymax,
                                  float xmax, uint8_t* desc, uint32_t* packed,
                                  void* stream) {
  if (nbits % 32 != 0 || nbits > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * (size_t)nc + 2);
  fc_describe_kernel<<<N, nbits, smem, (cudaStream_t)stream>>>(
      smooth, H, W, yx, cdy, cdx, nc, pairs, ymax, xmax, desc, packed);
  return (int)cudaGetLastError();
}

extern "C" int mo_match_launch(const uint32_t* pkl, const int* yxl, const uint8_t* vl,
                               const uint32_t* pkr, const int* yxr, const uint8_t* vr,
                               int NL, int NR, int max_disp, int row_tol, int* idx,
                               int* best, float* disp, void* stream) {
  const int threads = 128;
  mo_match_kernel<<<(NL + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      pkl, yxl, vl, pkr, yxr, vr, NL, NR, max_disp, row_tol, idx, best, disp);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
