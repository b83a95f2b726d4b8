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
// package where it truncates: hysteresis stops at 16 iterations. Min is
// exact, so only the pass boundaries matter, not the order inside a pass.
// Channels propagate independently, so each plane stops on its own; a plane
// that is unchanged after an iteration is a fixpoint of the body, which gives
// the same result as the reference's joint stop.
//
// Two routes; ops/cc_kernels.route picks one from the plane's shape before
// the launch (as cc_pallas.supported splits the JAX package's).
//
// CLUSTER ROUTE (cc_propagate_cluster): one thread-block cluster of K CTAs
// per (image, channel) plane, K = 8 (portable), or 16 where a stripe of 8
// does not fit. CTA `rank` holds rows [rank*S, rank*S + R) of the plane,
// S = ceil(H / K), in its shared memory, and reads its neighbours' stripes
// through distributed shared memory. One thread per column (blockDim =
// W rounded up to 32); a thread keeps its column's foreground bits in a
// register. Inside the kernel a background pixel holds +inf, so a pool is a
// plain min over the window; the store puts the seeds back.
//   - Pool sweep: each thread slides down its column, 3 shared loads per
//     pixel (the next row's left, centre, right), and computes the stripe's
//     new values into registers (at most RMAX = 32 or 64 of them); after a
//     CTA barrier it writes them back and pushes its first and last row into
//     the neighbours' halo rows (double-buffered by sweep parity), then one
//     cluster barrier. The halos a sweep reads were written before the
//     barrier that ended the previous sweep, so the sweep is Jacobi across
//     stripes.
//   - Row run-min: rows are whole in a stripe; one warp per row, a forward
//     segmented min scan with shuffles over 32-column chunks (the run's
//     start from the chunk's mask word, a carry between chunks), then a
//     backward pass that gives each pixel the forward value at its run's
//     end. The stripe's mask is kept as bits, one 32-bit word per chunk.
//   - Column run-min: each thread scans its column segment in registers,
//     publishes the min of the run touching its top row, of the run touching
//     its bottom row and whether the segment is all foreground; after a
//     cluster barrier it chains the other ranks' summaries above and below
//     into the carried-in minimum at each end and applies it. Exact.
//   - Stop: __syncthreads_or of "some value was lowered" (every step only
//     lowers, so that is "the plane changed"), ORed into every rank's stop
//     word (two words, by iteration parity) through DSMEM; one cluster
//     barrier; every rank reads its own word.
// Barriers: pool_iters + 2 cluster barriers per iteration, one at the start.
// Shared memory per CTA: stripe S x (W+2) int32 (an +inf pad column each
// side), halos 2 parities x 2 rows x (W+2) int32, mask bits S x ceil(W/32)
// words, column summaries 3 x W int32, 2 stop words:
//   448x384, K=8 (S=56):   86,464 +  6,176 + 2,688 + 4,608 + 8 =  99,944 B
//   448x512, K=8 (S=56):  115,136 +  8,224 + 3,584 + 6,144 + 8 = 133,096 B
//   448x800, K=16 (S=28):  89,824 + 12,832 + 2,800 + 9,600 + 8 = 115,064 B
// (the limit is 232,448 B). Capacity: S <= 32 with W <= 1024, or S <= 64
// with W <= 512 (the register array), within that limit; so H <= 512 (K=16)
// at W <= 1024, H <= 1024 (K=16) at W <= 512.
//
// GLOBAL ROUTE (cc_propagate_global): the first port's kernel, for planes
// beyond that capacity. One block of 1024 threads per plane; the plane and a
// ping-pong scratch plane live in device memory (L2-resident); pools are
// Jacobi sweeps from one plane into the other; the run-min passes use one
// thread per row (then per column), a forward then a backward sequential min
// over each run, in place.
//
// Bound: each input read once and the output written once (bytes), or the
// min/compare operations of the schedule (operations); see chip_smoke.py
// `_bound_ms`. The cluster route is paced by its barriers and the row and
// column carries, not by either.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kInf = INT_MAX;

// ---------------------------------------------------------------------------
// global route
// ---------------------------------------------------------------------------

constexpr int kGlobalThreads = 1024;

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
    int run = kInf;
    for (int i = 0; i < len; ++i) {
      const int o = i * step;
      if (!f[o]) { run = kInf; continue; }
      const int x = v[o];
      run = min(run, x);
      if (run < x) { v[o] = run; lowered = true; }
    }
    run = kInf;
    for (int i = len - 1; i >= 0; --i) {
      const int o = i * step;
      if (!f[o]) { run = kInf; continue; }
      const int x = v[o];
      run = min(run, x);
      if (run < x) { v[o] = run; lowered = true; }
    }
  }
  return lowered;
}

__global__ void __launch_bounds__(kGlobalThreads)
cc_propagate_global_kernel(const int* __restrict__ state0,
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

// ---------------------------------------------------------------------------
// cluster route
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;   // opt-in shared memory per block, sm_90

struct Stripe {
  int S;        // rows per CTA (the last ranks may hold fewer, or none)
  int threads;  // one per column, rounded up to a warp
  int smem;     // dynamic shared memory, bytes
};

Stripe stripe_of(int H, int W, int K) {
  Stripe s;
  s.S = (H + K - 1) / K;
  const int P = W + 2, NW = (W + 31) / 32;
  s.threads = NW * 32;
  s.smem = 4 * (s.S * P + 4 * P + s.S * NW + 3 * W + 2);
  return s;
}

// Returns x, hidden from the optimiser: walking a row offset through it
// keeps the compiler from precomputing every row's address of the stripe and
// holding them all in registers (which made the value arrays spill).
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Stripe loads and stores: 16 bytes a thread where `vec` (the row width is
// a multiple of 4 and the tensors are aligned), else 4. fn(i, col, n)
// handles n (4 or 1) consecutive pixels of stripe row i.
template <typename Fn>
__device__ void for_stripe(int R, int W, bool vec, Fn fn) {
  if (vec) {
    const int Q = W >> 2, n = R * Q;
    const int di = blockDim.x / Q, dq = blockDim.x - di * Q;
    int i = threadIdx.x / Q, q = threadIdx.x - i * Q;
#pragma unroll 4
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      fn(i, q << 2, 4);
      i += di;
      q += dq;
      if (q >= Q) { q -= Q; ++i; }
    }
  } else if ((int)threadIdx.x < W) {
    for (int i = 0; i < R; ++i) fn(i, (int)threadIdx.x, 1);
  }
}

template <int RMAX, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
cc_propagate_cluster_kernel(const int* __restrict__ state0,
                            const unsigned char* __restrict__ fg,
                            int* __restrict__ out, int C, int H, int W, int S,
                            int pool_iters, int max_iters, int connectivity,
                            int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long plane = blockIdx.x / K;  // b * C + c
  const long long hw = (long long)H * W;
  const int r0 = min(rank * S, H);
  const int R = min(S, H - r0);            // rows of this stripe
  const int P = W + 2, NW = (W + 31) >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c = tid;                       // the column this thread owns
  const bool col_ok = c < W;
  const bool conn8 = connectivity == 8;
  const unsigned long long full = R == 64 ? ~0ull : (1ull << R) - 1;

  extern __shared__ int smem[];
  int* buf = smem;                                         // S x P
  int* halo = buf + S * P;                                 // [parity][top, bottom] x P
  unsigned* bits = reinterpret_cast<unsigned*>(halo + 4 * P);  // S x NW
  int* sum = reinterpret_cast<int*>(bits + S * NW);        // [top, bottom, all] x W
  int* flag = sum + 3 * W;                                 // [2]

  const int* s0 = state0 + plane * hw + (long long)r0 * W;
  const unsigned char* f = fg + (plane / C) * hw + (long long)r0 * W;
  int* o = out + plane * hw + (long long)r0 * W;

  for (int j = tid; j < 4 * P; j += blockDim.x) halo[j] = kInf;
  for (int j = tid; j < S * NW; j += blockDim.x) bits[j] = 0;
  for (int i = tid; i < R; i += blockDim.x) buf[i * P] = buf[i * P + W + 1] = kInf;
  if (tid < 2) flag[tid] = 0;
  __syncthreads();

  for_stripe(R, W, vec, [&](int i, int col, int n) {
    int* d = buf + i * P + col + 1;
    unsigned m4;
    if (n == 4) {
      const int4 v = *reinterpret_cast<const int4*>(s0 + i * W + col);
      const uchar4 m = *reinterpret_cast<const uchar4*>(f + i * W + col);
      d[0] = m.x ? v.x : kInf;
      d[1] = m.y ? v.y : kInf;
      d[2] = m.z ? v.z : kInf;
      d[3] = m.w ? v.w : kInf;
      m4 = (m.x != 0) | (m.y != 0) << 1 | (m.z != 0) << 2 | (m.w != 0) << 3;
    } else {
      m4 = f[i * W + col] != 0;
      d[0] = m4 ? s0[i * W + col] : kInf;
    }
    if (m4) atomicOr(bits + i * NW + (col >> 5), m4 << (col & 31));
  });
  if (col_ok) {
    if (R > 0 && r0 > 0) halo[c + 1] = f[c - W] ? s0[c - W] : kInf;
    if (R > 0 && r0 + R < H) halo[P + c + 1] = f[R * W + c] ? s0[R * W + c] : kInf;
  }
  __syncthreads();
  unsigned long long fgb = 0;              // bit i: row i of my column is fg
  if (col_ok) {
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      if (i < R) fgb |= (unsigned long long)((bits[i * NW + (c >> 5)] >> (c & 31)) & 1u) << i;
    }
  }

  // my first row is the bottom halo of the rank above, my last row the top
  // halo of the rank below
  const bool has_up = rank > 0, has_dn = r0 + R < H;
  auto push = [&](int first, int last, int par) {
    if (col_ok && R > 0) {
      if (has_up) cluster.map_shared_rank(halo, rank - 1)[(2 * par + 1) * P + c + 1] = first;
      if (has_dn) cluster.map_shared_rank(halo, rank + 1)[2 * par * P + c + 1] = last;
    }
  };
  cluster.sync();   // every CTA of the cluster runs and is initialised

  int par = 0;      // the halo parity the next pool sweep reads
  for (int it = 0; it < max_iters; ++it) {
    bool lowered = false;

    for (int k = 0; k < pool_iters; ++k) {
      int nv[RMAX];
      int first = kInf, last = kInf;
      if (col_ok && R > 0) {
        const int* t = halo + 2 * par * P + c;
        int hp = min(min(t[0], t[1]), t[2]), cp = t[1];
        t = buf + c;
        int hc = min(min(t[0], t[1]), t[2]), cc = t[1];
        int off = c;
#pragma unroll
        for (int i = 0; i < RMAX; ++i) {
          if (i < R) {
            off = opaque(off + P);
            t = i + 1 < R ? buf + off : halo + (2 * par + 1) * P + c;
            const int hn = min(min(t[0], t[1]), t[2]), cn = t[1];
            const int m = conn8 ? min(min(hp, hc), hn) : min(min(cp, cn), hc);
            const int v = ((fgb >> i) & 1) ? m : kInf;
            lowered |= v < cc;
            nv[i] = v;
            if (i == 0) first = v;
            if (i == R - 1) last = v;
            hp = hc; cp = cc; hc = hn; cc = cn;
          }
        }
      }
      __syncthreads();   // every read of the stripe is done before it is written
      if (col_ok) {
        int off = c + 1;
#pragma unroll
        for (int i = 0; i < RMAX; ++i) {
          if (i < R) buf[off] = nv[i];
          off = opaque(off + P);
        }
      }
      par ^= 1;
      push(first, last, par);
      cluster.sync();
    }

    // segmented run-min along rows: one warp per row
    {
      const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1;  // lanes 0..lane
      for (int i = warp; i < R; i += nwarps) {
        int* row = buf + i * P + 1;
        const unsigned* rb = bits + i * NW;
        int carry = kInf;
#pragma unroll 4   // the chunks' scans are independent until the carry
        for (int k = 0; k < NW; ++k) {
          const int col = (k << 5) + lane;
          const unsigned bg = ~rb[k];           // lanes past W count as background
          const int orig = col < W ? row[col] : kInf;
          const unsigned before = bg & upto;
          const int start = before ? 32 - __clz(before) : 0;  // my run's first lane
          int x = orig;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(kFull, x, d);
            if (lane - d >= start) x = min(x, y);
          }
          if (start == 0) x = min(x, carry);
          carry = __shfl_sync(kFull, x, 31);
          lowered |= x < orig;
          if (col < W) row[col] = x;
        }
        int back = kInf;
#pragma unroll 4
        for (int k = NW - 1; k >= 0; --k) {
          const int col = (k << 5) + lane;
          const unsigned bg = ~rb[k];
          const int x = col < W ? row[col] : kInf;
          const unsigned after = bg & ~upto;
          int v = __shfl_sync(kFull, x, after ? __ffs(after) - 2 : 31);  // my run's last lane
          if (!after) v = min(v, back);
          if ((bg >> lane) & 1) v = x;
          const int v0 = __shfl_sync(kFull, v, 0);
          back = (bg & 1) ? kInf : v0;
          lowered |= v < x;
          if (col < W) row[col] = v;
        }
      }
    }
    __syncthreads();

    // segmented run-min along columns, across the stripes
    int v[RMAX];
    int top = kInf, bot = kInf;
    if (col_ok) {
      int run = kInf;
      int off = c + 1;
#pragma unroll
      for (int i = 0; i < RMAX; ++i) {
        if (i < R) {
          const int x = buf[off];
          off = opaque(off + P);
          run = ((fgb >> i) & 1) ? min(run, x) : kInf;
          lowered |= run < x;
          v[i] = run;
        }
      }
      run = kInf;
#pragma unroll
      for (int i = RMAX - 1; i >= 0; --i) {
        if (i < R) {
          run = ((fgb >> i) & 1) ? min(run, v[i]) : kInf;
          lowered |= run < v[i];
          v[i] = run;
          if (i == R - 1) bot = run;
        }
      }
      if (R > 0) top = v[0];
      sum[c] = top;
      sum[W + c] = bot;
      sum[2 * W + c] = fgb == full;
    }
    cluster.sync();
    if (tid == 0) flag[(it + 1) & 1] = 0;   // every rank has read it, last iteration
    int first = kInf, last = kInf;
    if (col_ok) {
      int A = kInf, Bm = kInf;   // carried in from above and from below
      bool open = true;
#pragma unroll 4
      for (int j = rank - 1; j >= 0; --j) {
        const int* rs = cluster.map_shared_rank(sum, j);
        const int b = rs[W + c], all = rs[2 * W + c];
        if (open) A = min(A, b);
        open = open && all;
      }
      open = true;
#pragma unroll 4
      for (int j = rank + 1; j < K; ++j) {
        const int* rs = cluster.map_shared_rank(sum, j);
        const int t = rs[c], all = rs[2 * W + c];
        if (open) Bm = min(Bm, t);
        open = open && all;
      }
      const unsigned long long gaps = ~fgb & full;
      const int head = gaps ? __ffsll((long long)gaps) - 1 : R;       // rows [0, head)
      const int tail = gaps ? 63 - __clzll((long long)gaps) : -1;     // rows (tail, R)
      int off = c + 1;
#pragma unroll
      for (int i = 0; i < RMAX; ++i) {
        if (i < R) {
          int y = v[i];
          if (i < head) y = min(y, A);
          if (i > tail) y = min(y, Bm);
          lowered |= y < v[i];
          buf[off] = y;
          off = opaque(off + P);
          if (i == 0) first = y;
          if (i == R - 1) last = y;
        }
      }
    }
    if (__syncthreads_or(lowered) && tid < K) {
      atomicOr(cluster.map_shared_rank(flag, tid) + (it & 1), 1);
    }
    par ^= 1;
    push(first, last, par);
    cluster.sync();
    if (!flag[it & 1]) break;
  }

  for_stripe(R, W, vec, [&](int i, int col, int n) {
    const int* d = buf + i * P + col + 1;
    if (n == 4) {
      const int4 v = *reinterpret_cast<const int4*>(s0 + i * W + col);
      const uchar4 m = *reinterpret_cast<const uchar4*>(f + i * W + col);
      *reinterpret_cast<int4*>(o + i * W + col) = make_int4(
          m.x ? d[0] : v.x, m.y ? d[1] : v.y, m.z ? d[2] : v.z, m.w ? d[3] : v.w);
    } else {
      o[i * W + col] = f[i * W + col] ? d[0] : s0[i * W + col];
    }
  });
}

cudaLaunchConfig_t cluster_config(const Stripe& s, int K, int blocks,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(s.threads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's attributes and writes how many clusters of this shape
// the card can hold at once.
template <int RMAX, int MAXT>
int prepare(const Stripe& s, int K, int* max_active) {
  auto kernel = cc_propagate_cluster_kernel<RMAX, MAXT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess && K > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(s, K, K, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(max_active, kernel, &cfg);
}

template <int RMAX, int MAXT>
int launch(const Stripe& s, int K, const int* state0, const unsigned char* fg,
           int* out, int B, int C, int H, int W, int pool_iters, int max_iters,
           int connectivity, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(s, K, K * B * C, stream, &attr);
  const int vec = (W % 4 == 0 && (size_t)state0 % 16 == 0 && (size_t)fg % 4 == 0
                   && (size_t)out % 16 == 0);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, cc_propagate_cluster_kernel<RMAX, MAXT>, state0, fg, out, C, H, W,
      s.S, pool_iters, max_iters, connectivity, vec);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Which instantiation holds a stripe: 0 none, 32 or 64 (its RMAX).
int variant(const Stripe& s, int K) {
  if ((K != 8 && K != 16) || s.smem > kMaxSmem) return 0;
  if (s.S <= 32 && s.threads <= 1024) return 32;
  if (s.S <= 64 && s.threads <= 512) return 64;
  return 0;
}

}  // namespace

// Launches on `stream`; `out` and `scratch` are (B, C, H, W) int32 planes the
// caller allocated. Returns cudaGetLastError() after the launch.
extern "C" int cc_propagate_global(const int* state0, const unsigned char* fg,
                                   int* out, int* scratch, int B, int C, int H,
                                   int W, int pool_iters, int max_iters,
                                   int connectivity, void* stream) {
  if (B * C == 0 || H * W == 0) return 0;
  cc_propagate_global_kernel<<<B * C, kGlobalThreads, 0, (cudaStream_t)stream>>>(
      state0, fg, out, scratch, C, H, W, pool_iters, max_iters, connectivity);
  return (int)cudaGetLastError();
}

// Call once per (device, H, W, K) before the first launch: sets the kernel's
// attributes and writes to *max_active how many K-CTA clusters of this plane
// shape fit on the card at once (0: none). Returns a CUDA error code, or
// cudaErrorInvalidValue if the shape is beyond the route's capacity.
extern "C" int cc_propagate_cluster_prepare(int H, int W, int K, int* max_active) {
  const Stripe s = stripe_of(H, W, K);
  switch (variant(s, K)) {
    case 32: return prepare<32, 1024>(s, K, max_active);
    case 64: return prepare<64, 512>(s, K, max_active);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches one K-CTA cluster per (image, channel) plane on `stream`; `out` is
// a (B, C, H, W) int32 tensor the caller allocated. Returns the launch's CUDA
// error code.
extern "C" int cc_propagate_cluster(const int* state0, const unsigned char* fg,
                                    int* out, int B, int C, int H, int W, int K,
                                    int pool_iters, int max_iters,
                                    int connectivity, void* stream) {
  if (B * C == 0 || H * W == 0) return 0;
  const Stripe s = stripe_of(H, W, K);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (variant(s, K)) {
    case 32: return launch<32, 1024>(s, K, state0, fg, out, B, C, H, W, pool_iters,
                                     max_iters, connectivity, st);
    case 64: return launch<64, 512>(s, K, state0, fg, out, B, C, H, W, pool_iters,
                                    max_iters, connectivity, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
