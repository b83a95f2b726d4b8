// Non-local-means denoising of a stack of float32 planes, for sm_90a.
//
// Replaces the TPU kernel unet_tpu/ops/nlm_pallas.py `nlm_padded`
// (:85-109, body `_kernel` :62-82). Contract, that of
// unet_tpu/ops/frames.py `nlm_denoise` (:60-127): for every pixel p of each
// (H, W) plane and every offset o in [-R, R]^2, (0, 0) included,
//   d2(p, o) = sum over the (2T+1)^2 box around p of (x[q] - x[q + o])^2
//   w(p, o)  = exp(-d2(p, o) / (h^2 (2T+1)^2))
//   out[p]   = sum_o w(p, o) x[p + o] / sum_o w(p, o)
// where x is the plane read with BORDER_REFLECT_101 indices. The (0, 0)
// offset has weight exp(0) = 1, the JAX package's centre-weight convention.
// The kernel reads the unpadded plane and applies the reflect-101 indices
// itself when it loads a tile, which equals the JAX package's reflect pad
// by R + T (the wrapper requires R + T <= H - 1 and W - 1).
//
// Not carried over from the TPU kernel: the (8, 128) lane padding, the
// circular `pltpu.roll` reads (no output pixel reads beyond the R + T halo,
// so nothing wraps) and the VMEM guard.
//
// Design: one block of 32 x 8 threads per 32 x 32 output tile of one plane.
// The tile and its R + T halo (58 x 58 floats at R = 10, T = 3) are staged
// once in shared memory. Then, for each of the (2R+1)^2 offsets:
//   1. the squared differences over the tile plus the T halo go to shared
//      memory (38 x 38 at T = 3),
//   2. their row box sums go to shared memory (38 x 32),
//   3. each thread sums 2T+1 of those rows for its 4 pixels (a column of 4
//      consecutive rows, read once into registers), takes expf of the
//      scaled sum and accumulates num and den in registers.
// Two barriers per offset. expf (not __expf) keeps the float tolerance of
// the JAX package's own tests against the XLA path (rtol 2e-5, atol 2e-3).
//
// Bound: one exp per pixel per offset at the SFU rate (16 per SM per clock)
// sets the least time, about 0.3 ms for a (8, 448, 800) launch with 441
// offsets; the bytes (one read, one write) take about 7 us. The kernel
// instead makes about 17 shared-memory accesses per pixel per offset
// (4 for the differences, 9.5 for the row sums, 3.5 in step 3), so shared
// memory, not the SFU, should limit it. Later work: running box sums, fewer
// barriers, more pixels per thread.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 32;
constexpr int kRowsPerThread = 4;
constexpr int kThreadsY = kTileY / kRowsPerThread;
constexpr int kThreads = kTileX * kThreadsY;

// BORDER_REFLECT_101 for |overhang| <= n - 1. The clamp only keeps the
// rows and columns beyond a partial tile's last pixel in range; their
// results are never stored.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
nlm_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W,
           int R, float neg_scale) {
  extern __shared__ float smem[];
  const int halo = R + T;
  const int XW = kTileX + 2 * halo;          // staged tile
  const int XH = kTileY + 2 * halo;
  constexpr int DW = kTileX + 2 * T;         // squared-difference region
  constexpr int DH = kTileY + 2 * T;
  float* X = smem;                           // XH * XW
  float* D = X + XH * XW;                    // DH * DW
  float* S = D + DH * DW;                    // DH * kTileX row box sums

  const long long plane = (long long)blockIdx.z * H * W;
  const float* img = x + plane;
  const int y0 = blockIdx.y * kTileY;
  const int x0 = blockIdx.x * kTileX;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  for (int i = tid; i < XH * XW; i += kThreads) {
    const int sy = i / XW;
    const int sx = i - sy * XW;
    X[i] = img[(long long)reflect101(y0 - halo + sy, H) * W +
               reflect101(x0 - halo + sx, W)];
  }

  const int tx = threadIdx.x;
  const int ty = threadIdx.y * kRowsPerThread;   // first of this thread's rows
  float num[kRowsPerThread], den[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) num[j] = den[j] = 0.f;
  __syncthreads();

  for (int dy = -R; dy <= R; ++dy) {
    for (int dx = -R; dx <= R; ++dx) {
      const int off = dy * XW + dx;
      // 1. squared differences; region (0, 0) is X (R, R)
      for (int i = tid; i < DH * DW; i += kThreads) {
        const int ry = i / DW;
        const int rx = i - ry * DW;
        const int p = (ry + R) * XW + rx + R;
        const float d = X[p] - X[p + off];
        D[i] = d * d;
      }
      __syncthreads();
      // 2. row box sums: S[ry][c] = sum_k D[ry][c + k], k = 0 .. 2T
      for (int i = tid; i < DH * kTileX; i += kThreads) {
        const int ry = i / kTileX;
        const int c = i - ry * kTileX;
        const float* d = D + ry * DW + c;
        float s = d[0];
#pragma unroll
        for (int k = 1; k <= 2 * T; ++k) s += d[k];
        S[i] = s;
      }
      __syncthreads();
      // 3. column box sums, weights and the accumulators of this thread's
      //    pixels (tile rows ty .. ty + 3, column tx)
      float col[kRowsPerThread + 2 * T];
#pragma unroll
      for (int k = 0; k < kRowsPerThread + 2 * T; ++k) col[k] = S[(ty + k) * kTileX + tx];
      const float* shifted = X + (ty + halo + dy) * XW + tx + halo + dx;
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        float s = col[j];
#pragma unroll
        for (int k = 1; k <= 2 * T; ++k) s += col[j + k];
        const float w = expf(s * neg_scale);
        num[j] += w * shifted[j * XW];
        den[j] += w;
      }
    }
  }

  const int c = x0 + tx;
  if (c >= W) return;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = y0 + ty + j;
    if (r < H) out[plane + (long long)r * W + c] = num[j] / den[j];
  }
}

template <int T>
int launch(const float* x, float* out, int B, int H, int W, int R,
           float neg_scale, cudaStream_t stream) {
  const int halo = R + T;
  const size_t smem = sizeof(float) *
      ((size_t)(kTileY + 2 * halo) * (kTileX + 2 * halo) +
       (size_t)(kTileY + 2 * T) * (kTileX + 2 * T) +
       (size_t)(kTileY + 2 * T) * kTileX);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nlm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, B);
  const dim3 block(kTileX, kThreadsY);
  nlm_kernel<T><<<grid, block, smem, stream>>>(x, out, H, W, R, neg_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// x and out: (B, H, W) float32, contiguous, on the device; `out` is
// allocated by the caller. search = 2R + 1, template = 2T + 1 with
// T in 0 .. 5. Launches on `stream` and returns cudaGetLastError() after
// the launch; -1 for a template the kernel is not built for.
extern "C" int nlm_denoise(const float* x, float* out, int B, int H, int W,
                           int search, int templ, double h, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const int R = search / 2;
  const int T = templ / 2;
  const float neg_scale = (float)(-1.0 / (h * h * (double)templ * templ));
  cudaStream_t s = (cudaStream_t)stream;
  switch (T) {
    case 0: return launch<0>(x, out, B, H, W, R, neg_scale, s);
    case 1: return launch<1>(x, out, B, H, W, R, neg_scale, s);
    case 2: return launch<2>(x, out, B, H, W, R, neg_scale, s);
    case 3: return launch<3>(x, out, B, H, W, R, neg_scale, s);
    case 4: return launch<4>(x, out, B, H, W, R, neg_scale, s);
    case 5: return launch<5>(x, out, B, H, W, R, neg_scale, s);
    default: return -1;
  }
}
