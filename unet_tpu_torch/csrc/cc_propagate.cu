// Masked min-propagation fixpoint: connected-component labels, bounding
// boxes and Canny hysteresis, for sm_90a.
//
// Replaces the TPU kernel unet_tpu/ops/cc_pallas.py `propagate` (:152-190),
// whose body is `_kernel` (:71-149). Contract: state (B, C, H, W) int32 and a
// (B, H, W) foreground mask; each channel becomes the minimum of its seeds
// over every 8- (or 4-) connected foreground component, background keeps
// its seed. One outer iteration is, exactly as in the reference:
//   1. `pool_iters` Jacobi (never in-place) masked 3x3 / cross min-pools,
//   2. a segmented run-min along every row,
//   3. a segmented run-min along every column,
// repeated until nothing changes or `max_iters` iterations ran. Holding the
// schedule (not only the fixpoint) keeps the result bit-identical to the JAX
// package where it truncates: hysteresis stops at 16 iterations.
//
// Design: one block of 1024 threads per (image, channel) plane. Channels
// propagate independently, so each block stops on its own; a channel that
// is unchanged after an iteration is a fixpoint of the body, which gives the
// same result as the reference's joint stop. A 448x384 int32 plane (688 KB)
// does not fit in a block's 227 KB of shared memory, so the plane and a
// ping-pong scratch plane live in device memory (L2-resident). Pools are
// Jacobi sweeps from one plane into the other with a barrier between them;
// the run-min passes use one thread per row (then per column): a forward
// then a backward sequential min over each foreground run, in place.
// Every step only lowers values, so "some write lowered a value" is exactly
// "the plane differs from the iteration's starting plane"; the block-wide
// OR of that flag (__syncthreads_or) decides the stop.
//
// Bound: device-memory/L2 traffic of about (2 * pool_iters + 4) * 4 bytes
// per pixel per channel per iteration (each pool sweep reads and writes the
// plane once; the row and the column pass each read and write it once).
// Few blocks are in flight (B * C of them), and the scans are sequential in
// each thread. Later work tiles the plane into shared memory with halos and
// spreads a plane over several blocks.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

// One masked min-pool sweep, src -> dst. Returns whether this thread
// lowered any value.
__device__ bool pool_sweep(const int* __restrict__ src, int* __restrict__ dst,
                           const unsigned char* __restrict__ fg, int H, int W,
                           int connectivity) {
  bool lowered = false;
  const int hw = H * W;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    int v = src[p];
    if (fg[p]) {
      const int r = p / W;
      const int c = p - r * W;
      int m = v;
      for (int dr = -1; dr <= 1; ++dr) {
        const int rr = r + dr;
        if (rr < 0 || rr >= H) continue;
        for (int dc = -1; dc <= 1; ++dc) {
          if (connectivity == 4 && dr != 0 && dc != 0) continue;
          const int cc = c + dc;
          if (cc < 0 || cc >= W) continue;
          const int q = rr * W + cc;
          if (fg[q]) m = min(m, src[q]);
        }
      }
      lowered |= m < v;
      v = m;
    }
    dst[p] = v;
  }
  return lowered;
}

// Segmented run-min, in place, over `lines` lines of `len` elements: element
// i of line l sits at l * line_stride + i * step.
__device__ bool run_min(int* s, const unsigned char* __restrict__ fg,
                        int lines, int len, int line_stride, int step) {
  bool lowered = false;
  for (int l = threadIdx.x; l < lines; l += blockDim.x) {
    int* v = s + l * line_stride;
    const unsigned char* f = fg + l * line_stride;
    int run = INT_MAX;
    for (int i = 0; i < len; ++i) {
      const int o = i * step;
      if (!f[o]) { run = INT_MAX; continue; }
      const int x = v[o];
      run = min(run, x);
      if (run < x) { v[o] = run; lowered = true; }
    }
    run = INT_MAX;
    for (int i = len - 1; i >= 0; --i) {
      const int o = i * step;
      if (!f[o]) { run = INT_MAX; continue; }
      const int x = v[o];
      run = min(run, x);
      if (run < x) { v[o] = run; lowered = true; }
    }
  }
  return lowered;
}

__global__ void __launch_bounds__(kThreads)
cc_propagate_kernel(const int* __restrict__ state0,
                    const unsigned char* __restrict__ fg, int* out,
                    int* scratch, int C, int H, int W, int pool_iters,
                    int max_iters, int connectivity) {
  const long long plane = blockIdx.x;  // b * C + c
  const long long hw = (long long)H * W;
  const unsigned char* f = fg + (plane / C) * hw;
  int* a = out + plane * hw;
  int* cur = a;
  int* other = scratch + plane * hw;
  const int* s0 = state0 + plane * hw;

  for (int p = threadIdx.x; p < hw; p += blockDim.x) a[p] = s0[p];
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    bool lowered = false;
    for (int k = 0; k < pool_iters; ++k) {
      lowered |= pool_sweep(cur, other, f, H, W, connectivity);
      __syncthreads();
      int* t = cur; cur = other; other = t;
    }
    lowered |= run_min(cur, f, H, W, W, 1);   // rows
    __syncthreads();
    lowered |= run_min(cur, f, W, H, 1, W);   // columns
    if (!__syncthreads_or(lowered)) break;
  }

  if (cur != a) {
    for (int p = threadIdx.x; p < hw; p += blockDim.x) a[p] = cur[p];
  }
}

}  // namespace

// Launches on `stream`; `out` and `scratch` are (B, C, H, W) int32 planes the
// caller allocated. Returns cudaGetLastError() after the launch.
extern "C" int cc_propagate(const int* state0, const unsigned char* fg,
                            int* out, int* scratch, int B, int C, int H,
                            int W, int pool_iters, int max_iters,
                            int connectivity, void* stream) {
  if (B * C == 0 || H * W == 0) return 0;
  cc_propagate_kernel<<<B * C, kThreads, 0, (cudaStream_t)stream>>>(
      state0, fg, out, scratch, C, H, W, pool_iters, max_iters, connectivity);
  return (int)cudaGetLastError();
}
