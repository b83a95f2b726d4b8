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
// Bound: one exp per weight at the SFU rate, or the fp32 arithmetic around
// it (chip_smoke.py `_nlm_bound_ms`); the bytes (one read, one write) take
// about 7 us at (8, 448, 800). With shared memory and barriers off the
// offset loop, instruction issue paces the kernel (4 warp-instructions per
// SM per clock): per offset a warp of this kernel issues about 37
// instructions for each of its pairs of rows of pixels, 26 of them fp32
// (differences and squares, the box sums, the scale, the two accumulators),
// 4 shuffles, 2 MUFU exp2 and under 2 shared-memory loads. The weight is
// the MUFU exp2 alone: expf's range reduction would add about 15 more (a
// third of the issue), and the MUFU exp2 keeps the JAX package's float
// tolerance.
//
// Design: a block of kWarps warps stages its output tile plus the R + T
// halo once in shared memory, behind the only barrier. The staged plane is
// kept twice, the second copy one column to the left, so that a lane reads
// any two neighbouring columns as one aligned 8-byte load. Each warp owns a
// strip of kRows output rows and 64 input columns, two neighbouring columns
// a lane; the T columns at each end are the box's halo, so a block's tile is
// 64 - 2T columns wide. For each of the (2R+1)^2 offsets a lane then:
//   1. loads the shifted values x[q + o] of its two columns for the strip's
//      kRows + 2T rows (one shared-memory load a row; the centre values x[q]
//      sit in registers for the whole offset loop),
//   2. squares the differences and sums each column's 2T+1 rows in
//      registers, in a fixed order (pairs, then quads, ...): no running
//      add/subtract, whose cancellation would drift across a strip,
//   3. sums 2T+1 columns of those with warp shuffles (the columns of the
//      neighbouring lanes; T = 3 takes 4 shuffles for the lane's two
//      pixels), takes the weight (`weight`) of the scaled box sum and
//      accumulates num and den of its 2 x kRows pixels in registers;
//      x[p + o] is the shifted value of step 1.
// No barrier and no shared-memory store inside the offset loop. kRows = 16
// takes about 168 registers and no spill; the weight, from the MUFU exp2
// (ex2.approx), stays inside the tolerance of the JAX package's own tests
// against the XLA path (rtol 2e-5, atol 2e-3).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCols = 64;            // input columns of a strip, 2 a lane
constexpr int kWarps = 4;            // strips stacked in a block
constexpr int kRows = 16;            // output rows of a strip
constexpr int kThreads = 32 * kWarps;

template <int T>
struct Tile {
  static constexpr int kX = kCols - 2 * T;     // output columns of a block
  static constexpr int kY = kWarps * kRows;    // output rows of a block
  static constexpr int kIn = kRows + 2 * T;    // input rows of a strip
};

// BORDER_REFLECT_101 for |overhang| <= n - 1. The clamp only keeps the
// rows and columns beyond a partial tile's last pixel in range; their
// results are never stored.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

// v[j] = d[j] + ... + d[j + N - 1] for j = 0 .. LEN - N (N = 2T + 1 <= 15)
// in a fixed order: sums of 2, 4, 8 terms (s1, s2, s3), then the binary
// pieces of N left to right. Every loop has a constant trip count, so all
// unroll and the arrays stay in registers.
template <int N, int LEN>
__device__ __forceinline__ void box_rows(const float (&d)[LEN], float (&v)[LEN - N + 1]) {
  static_assert(N >= 1 && N < 16, "box of 1 .. 15 rows");
  float s1[LEN], s2[LEN], s3[LEN];
  if constexpr (N >= 2) {
#pragma unroll
    for (int i = 0; i + 1 < LEN; ++i) s1[i] = d[i] + d[i + 1];
  }
  if constexpr (N >= 4) {
#pragma unroll
    for (int i = 0; i + 3 < LEN; ++i) s2[i] = s1[i] + s1[i + 2];
  }
  if constexpr (N >= 8) {
#pragma unroll
    for (int i = 0; i + 7 < LEN; ++i) s3[i] = s2[i] + s2[i + 4];
  }
  constexpr int kTop = N >= 8 ? 8 : N >= 4 ? 4 : N >= 2 ? 2 : 1;
#pragma unroll
  for (int j = 0; j + N <= LEN; ++j) {
    float t = kTop == 8 ? s3[j] : kTop == 4 ? s2[j] : kTop == 2 ? s1[j] : d[j];
    int off = kTop;
    if constexpr (kTop > 4 && (N & 4)) { t += s2[j + off]; off += 4; }
    if constexpr (kTop > 2 && (N & 2)) { t += s1[j + off]; off += 2; }
    if constexpr (kTop > 1 && (N & 1)) { t += d[j + off]; }
    v[j] = t;
  }
}

__device__ __forceinline__ float up(float v, int d) { return __shfl_up_sync(kFull, v, d); }
__device__ __forceinline__ float down(float v, int d) { return __shfl_down_sync(kFull, v, d); }

// The box sums of the lane's two pixels (columns 2l and 2l+1 of the strip),
// from the column sums a (2l) and b (2l+1) of every lane: columns
// 2l - T .. 2l + T and 2l + 1 - T .. 2l + 1 + T. Lanes whose box leaves the
// strip get values that are never stored.
template <int T>
__device__ __forceinline__ void box_cols(float a, float b, float& s0, float& s1) {
  if constexpr (T == 0) {
    s0 = a;
    s1 = b;
  } else {
    const float q = a + b;           // the lane's pair
    constexpr int m = T / 2;
    if constexpr (T % 2 == 1) {
      // pairs l - m .. l + m, then b of lane l - m - 1 or a of lane l + m + 1
      float c = m ? up(q, m) : q;
#pragma unroll
      for (int k = m - 1; k >= 1; --k) c += up(q, k);
      if constexpr (m > 0) c += q;
#pragma unroll
      for (int k = 1; k <= m; ++k) c += down(q, k);
      s0 = up(b, m + 1) + c;
      s1 = c + down(a, m + 1);
    } else {
      // pairs l - m + 1 .. l + m - 1, then the pieces at both ends:
      // 2l: q of lane l - m and a of lane l + m; 2l + 1: b of lane l - m
      // and q of lane l + m
      float c = q;
#pragma unroll
      for (int k = 1; k < m; ++k) c = up(q, k) + c + down(q, k);
      s0 = up(q, m) + c + down(a, m);
      s1 = up(b, m) + c + down(q, m);
    }
  }
}

// The weight exp(-d2 / (h^2 (2T+1)^2)) from the box sum s by the MUFU exp2
// alone: ex2.approx(s * k) with k = -log2(e) / (h^2 (2T+1)^2) (2 ulp;
// flushes weights below 2^-126 to 0).
__device__ __forceinline__ float weight(float s, float k) {
  float w;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(w) : "f"(s * k));
  return w;
}

template <int T>
__global__ void __launch_bounds__(kThreads)
nlm_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W,
           int R, float scale) {
  using G = Tile<T>;
  extern __shared__ float2 smem2[];
  const int halo = R + T;
  const int SW = kCols + 2 * R;              // staged width, even
  const int SH = G::kY + 2 * halo;           // staged height
  // X0[i * SW + j] = x(y0 - halo + i, x0 - halo + j); X1[k] = X0[k + 1]
  float* X0 = reinterpret_cast<float*>(smem2);
  float* X1 = X0 + SH * SW;

  const long long plane = (long long)blockIdx.z * H * W;
  const float* img = x + plane;
  const int y0 = blockIdx.y * G::kY;
  const int x0 = blockIdx.x * G::kX;
  for (int i = threadIdx.x; i < SH * SW; i += kThreads) {
    const int sy = i / SW;
    const int sx = i - sy * SW;
    const float* row = img + (long long)reflect101(y0 - halo + sy, H) * W;
    X0[i] = row[reflect101(x0 - halo + sx, W)];
    X1[i] = row[reflect101(x0 - halo + sx + 1, W)];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Input row i of the strip is image row y0 + warp * kRows - T + i, staged
  // row warp * kRows + R + i; the lane's input columns 2l, 2l + 1 are image
  // columns x0 - T + 2l (+1), staged column c (+1).
  const int row0 = (warp * kRows + R) * SW;
  const int c = 2 * lane + R;
  // two neighbouring staged columns k, k + 1 as one aligned float2
  auto pair = [&](int k) { return X0 + (k & 1) * (SH * SW) + (k & ~1); };

  float2 ctr[G::kIn];
  {
    const float* p = pair(c) + row0;
#pragma unroll
    for (int i = 0; i < G::kIn; ++i) ctr[i] = *reinterpret_cast<const float2*>(p + i * SW);
  }
  float num0[kRows], num1[kRows], den0[kRows], den1[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) num0[j] = num1[j] = den0[j] = den1[j] = 0.f;

  for (int dy = -R; dy <= R; ++dy) {
    for (int dx = -R; dx <= R; ++dx) {
      const float* p = pair(c + dx) + row0 + dy * SW;
      float sq0[G::kIn], sq1[G::kIn], sh0[kRows], sh1[kRows];
#pragma unroll
      for (int i = 0; i < G::kIn; ++i) {
        const float2 s = *reinterpret_cast<const float2*>(p + i * SW);
        const float e0 = ctr[i].x - s.x;
        const float e1 = ctr[i].y - s.y;
        sq0[i] = e0 * e0;
        sq1[i] = e1 * e1;
        if (i >= T && i < T + kRows) {
          sh0[i - T] = s.x;
          sh1[i - T] = s.y;
        }
      }
      float v0[kRows], v1[kRows];
      box_rows<2 * T + 1>(sq0, v0);
      box_rows<2 * T + 1>(sq1, v1);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        float s0, s1;
        box_cols<T>(v0[j], v1[j], s0, s1);
        const float w0 = weight(s0, scale);
        const float w1 = weight(s1, scale);
        num0[j] += w0 * sh0[j];
        den0[j] += w0;
        num1[j] += w1 * sh1[j];
        den1[j] += w1;
      }
    }
  }

  // the lane's columns hold an output where their box lies in the strip
  const int gx = x0 - T + 2 * lane;
  const bool ok0 = 2 * lane >= T && 2 * lane <= kCols - 1 - T && gx < W;
  const bool ok1 = 2 * lane + 1 >= T && 2 * lane + 1 <= kCols - 1 - T && gx + 1 < W;
  const int gy = y0 + warp * kRows;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (gy + j >= H) break;
    float* o = out + plane + (long long)(gy + j) * W + gx;
    if (ok0) o[0] = num0[j] / den0[j];
    if (ok1) o[1] = num1[j] / den1[j];
  }
}

template <int T>
int launch(const float* x, float* out, int B, int H, int W, int R,
           float scale, cudaStream_t stream) {
  using G = Tile<T>;
  const int halo = R + T;
  const size_t smem = sizeof(float) * 2 * (size_t)(G::kY + 2 * halo) * (kCols + 2 * R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nlm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + G::kX - 1) / G::kX, (H + G::kY - 1) / G::kY, B);
  nlm_kernel<T><<<grid, kThreads, smem, stream>>>(x, out, H, W, R, scale);
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
  // -log2(e) / (h^2 templ^2), folded in double
  const float scale = (float)(-1.4426950408889634 / (h * h * (double)templ * templ));
  cudaStream_t s = (cudaStream_t)stream;
  switch (T) {
    case 0: return launch<0>(x, out, B, H, W, R, scale, s);
    case 1: return launch<1>(x, out, B, H, W, R, scale, s);
    case 2: return launch<2>(x, out, B, H, W, R, scale, s);
    case 3: return launch<3>(x, out, B, H, W, R, scale, s);
    case 4: return launch<4>(x, out, B, H, W, R, scale, s);
    case 5: return launch<5>(x, out, B, H, W, R, scale, s);
    default: return -1;
  }
}
