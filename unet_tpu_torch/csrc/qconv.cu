// int8 3x3 convolution with its requantization fused, for sm_90a.
//
// Replaces, on the int8 forward of the NestedUNet, what the JAX package
// leaves to XLA: unet_tpu/models/quantized.py `_qconv` (:183-204,
// lax.conv_general_dilated s8 x s8 -> s32, stride 1, pad 1, NHWC/HWIO) and
// the elementwise `_requant` (:207-219) on its int32 accumulator. It is not
// a TPU kernel (no pl.pallas_call): PyTorch has no eager CUDA int8
// convolution, so the port writes one.
//
// Contract (`qconv_kernels.qconv`): for NHWC int8 sources xa (B,H,W,Ca) and
// xb (B,H,W,Cb) (Cb = 0 for one source; a pair is a decoder concat that is
// never materialised: input channel c < Ca reads xa, the rest xb) and
// weights w (N, 3, 3, Ca+Cb) int8 (OHWI, K = 9 (Ca+Cb) flattened as
// (tap, c)):
//   acc[m, n] = sum_{dy, dx, c} x[b, y+dy-1, x+dx-1, c] * w[n, dy, dx, c]
//               (zero outside the plane), exact in int32;
//   out[m, n] = int8(clip(rint(t), 0, 127)) with, in the compute type
//     bf16: t = bf16(bf16(bf16(float(acc)) * mult[n]) + bias[n])
//     f32:  t = float(acc) * mult[n] + bias[n]  (two roundings, no FMA)
// where each bf16(...) rounds a float32 result to bf16, round half to
// even. That is the XLA CPU chain and PyTorch's bf16 arithmetic: each op in
// float32, then rounded to the type, so the sum is rounded twice (float32,
// then bf16); `add.rn.bf16` would round once and differ. The int32 -> bf16
// cast goes through float32 for the same reason. `__fmul_rn`/`__fadd_rn`
// keep nvcc from contracting the chain into an FMA. rintf is round half to
// even, as jnp.round.
//
// Bound on the H100 (chip_smoke.py `_qconv_bound_ms`): the 2 M N 9 C int8
// operations at 1,979 TOP/s, or the bytes (each input read once, the
// weights once, the output written once) at 3.35 TB/s. The 512^2 layers
// with N = 32 (M = B * 512^2) are bound by bytes: 9 C input bytes per pixel
// give only 2 * 32 * 9 C operations, and the tile re-reads every input
// pixel once per tap through L2, which no tile of this design avoids. The
// layers at 128^2 and below are bound by operations (K = 9 C up to 6912,
// N up to 512), and the 256^2 ones sit near the line.
//
// Design: implicit GEMM, M = output pixels, N = output channels, K = 9 C
// ordered (tap, c), never an im2col. Three routes, picked by the wrapper
// from the shapes, the plane width and the alignment alone
// (`qconv_kernels.route`):
//
// * wgmma (every source's channel count a multiple of 32, the buffers
//   16-byte aligned: 17 of the 18 convs of the int8 forward). A block of
//   two warpgroups computes a 128 x BN tile (BN = 128, 64 or 32, the
//   largest that divides N) with wgmma.mma_async m64nBNk32 s8 x s8 -> s32,
//   A and B both read from shared memory by descriptor, so the tensor cores
//   take whole 64 x BN x 32 steps and no thread loads a fragment. The K
//   loop walks 128-byte slices (4 wgmma k32 steps) through a 4-stage ring
//   in dynamic shared memory, 128-byte swizzled (16-byte chunk j of row r
//   at chunk j ^ (r & 7), 8-row atoms of 1 KiB), so neither the copies in
//   nor the tensor cores' reads conflict on banks. Every thread fills its
//   chunks with 16-byte cp.async copies; a chunk's k = 128 kt + 16 j names
//   one tap and one source (C % 32 == 0), and the copy is zero-filled for
//   the conv's padding, for pixels past M and for the K tail past 9 C.
//   Loads run two slices ahead while one wgmma group is in flight. The
//   epilogue requantizes the accumulators in registers, writes the int8
//   tile into the idle ring and stores it in coalesced 16-byte rows.
// * c3 (conv0_0.conv1: one source of 3 channels, N % 32 == 0, 3 W % 16 ==
//   0, 16-byte aligned buffers). K = 27 is one k32 step, and the layer's
//   bound is set by its bytes (the 32-byte output rows), 12x over its
//   tensor-core operations. A block covers 2 rows x 64 columns
//   of one image (128 pixels) and 32 output channels. It stages input rows
//   y0 - 1 .. y0 + 2 over columns x0 - 1 .. x0 + 64 as NHWC bytes in a
//   shared-memory halo tile: 14 aligned 16-byte cp.async chunks a row, from
//   the chunk before the tile (its last 3 bytes are the left halo pixel)
//   to the one after it (its first 3 are the right one). A chunk outside
//   this image's rows or its row's bytes is zero-filled, so the halo's
//   zeros are the conv's padding (3 W % 16 == 0: no chunk straddles a row
//   end). With k = 9 dy + 3 dx + c, a pixel's K row is three runs of 9
//   contiguous halo bytes and 5 zero bytes; the threads build the 128 x 32
//   A tile from the halo (C = 3 a constant: no division or bounds test per
//   byte), and the block's 32 x 27 weights, one aligned 864-byte run of w,
//   into a zero-padded 32 x 32 B tile. One mma.sync m16n8k32 step per
//   16 x 8 tile with the mma.sync route's fragments and epilogue; the int8
//   tile goes back through the A tile's space and leaves in 16-byte stores,
//   consecutive threads on consecutive bytes (N = 32: a tile row is one
//   2 KiB run of NHWC). Measured (PERF.md §6), it is paced by the
//   epilogue, not by its bytes: the bf16 chain makes 6 conversions an
//   output byte (int -> float, 3 float -> bf16, rint, float -> int), the
//   float32 one 3, and the same launch with a float32 epilogue takes about
//   half the time, as a conversion rate of 16 values per SM per clock
//   predicts (0.096 ms for the 67 M outputs of a b=8 batch at 512^2).
// * mma.sync (the first kernel; the byte path of Cin not a multiple of 32
//   and of ragged or misaligned shapes): 8 warps of mma.sync m16n8k32 on a
//   3-stage ring of 32-byte slices with rows padded to 48 bytes; a slice is
//   gathered byte by byte over (tap, c) when a channel count is not a
//   multiple of 32; 2-byte stores straight to device memory. `qconv_s8_sync`
//   reaches it at any shape, so that it can be timed beside the other two.
//
// Three traps of the wgmma route, and what the kernel does about each:
// 1. cp.async writes shared memory through the generic proxy and wgmma
//    reads it through the async proxy: after cp.async.wait_group each
//    thread runs fence.proxy.async.shared::cta before the barrier that
//    hands the stage to wgmma. Without it a stale tile is read only now and
//    then, so a small test can pass and a large one fail.
// 2. A stage is refilled only after the wgmma group that reads it has
//    retired: with one group in flight, wgmma.wait_group 1 at the end of
//    slice kt retires group kt - 1, and the next slice's barrier precedes
//    the refill of stage (kt - 1) % 4. wgmma.fence precedes the wgmmas
//    that touch the accumulator registers, and empty asm statements keep
//    nvcc from moving the accumulators across the async instructions.
// 3. For .s8, wgmma takes A and B only K-major. Both are: A is (pixel,
//    tap C + c) from NHWC sources, B the OHWI weights flattened to (N, 9 C).
//    The 16-byte copies need every source and the weights 16-byte aligned.
//
// TMA, a persistent grid, warp specialisation and BN 256 are later work
// (ROADMAP B3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- the mma.sync route (the first kernel): the byte path, and any shape

constexpr int kBM = 128;       // output pixels of a block
constexpr int kBK = 32;        // K slice: one mma.sync k32 step
constexpr int kPitch = 48;     // shared-memory bytes per row: 32 + 16 padding
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N

struct Src {                   // one NHWC int8 source of the input channels
  const int8_t* p;
  int c;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16>
__device__ __forceinline__ float load_param(const void* p, int n) {
  if (kBf16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[n]);
  return reinterpret_cast<const float*>(p)[n];
}

template <bool kBf16>
__device__ __forceinline__ int8_t requant(int acc, float mult, float bias) {
  float t;
  if (kBf16) {
    t = round_bf16(__int2float_rn(acc));
    t = round_bf16(__fmul_rn(t, mult));
    t = round_bf16(__fadd_rn(t, bias));
  } else {
    t = __fadd_rn(__fmul_rn(__int2float_rn(acc), mult), bias);
  }
  t = fminf(fmaxf(rintf(t), 0.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(t));
}

// input channel c (< Ca + Cb) of pixel (b, y, x) of the pair, 0 outside the plane
__device__ __forceinline__ uint32_t gather_byte(const Src& xa, const Src& xb, int b, int y,
                                                int x, int c, int H, int W) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0;
  const long pix = (static_cast<long>(b) * H + y) * W + x;
  const int8_t v = c < xa.c ? xa.p[pix * xa.c + c] : xb.p[pix * xb.c + (c - xa.c)];
  return static_cast<uint8_t>(v);
}

template <int BN, bool kVec, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    qconv_sync_kernel(Src xa, Src xb, const int8_t* __restrict__ w, const void* mult,
                 const void* bias, int8_t* __restrict__ out, int B, int H, int W, int N) {
  constexpr int kWN = BN / 2;   // columns of a warp
  constexpr int kNI = kWN / 8;  // n8 tiles of a warp
  __shared__ __align__(16) int8_t sA[kStages][kBM * kPitch];
  __shared__ __align__(16) int8_t sB[kStages][BN * kPitch];

  const int C = xa.c + xb.c;
  const int K = 9 * C;
  const int KT = (K + kBK - 1) / kBK;
  const long M = static_cast<long>(B) * H * W;
  const long m0 = static_cast<long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;

  // the A row this thread loads: 16 of the slice's 32 bytes of one pixel
  const int a_row = tid >> 1, a_half = tid & 1;
  const long am = m0 + a_row;
  const bool a_in = am < M;
  int ab = 0, ay = 0, ax = 0;
  if (a_in) {
    ax = static_cast<int>(am % W);
    const long r = am / W;
    ay = static_cast<int>(r % H);
    ab = static_cast<int>(r / H);
  }

  auto load_stage = [&](int stage, int kt) {
    int8_t* dA = &sA[stage][a_row * kPitch + a_half * 16];
    if (kVec) {
      // C % 32 == 0: the slice is one tap of one source
      const int k0 = kt * kBK;
      const int tap = k0 / C, c0 = k0 - tap * C;
      const int iy = ay + tap / 3 - 1, ix = ax + tap % 3 - 1;
      const bool ok = a_in && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const bool first = c0 < xa.c;
      const Src s = first ? xa : xb;
      const int cc = (first ? c0 : c0 - xa.c) + a_half * 16;
      const int8_t* src =
          ok ? s.p + ((static_cast<long>(ab) * H + iy) * W + ix) * s.c + cc : xa.p;
      cp_async16(dA, src, ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (a_in) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = kt * kBK + a_half * 16 + j;
          if (k < K) {
            const int tap = k / C, c = k - tap * C;
            v[j >> 2] |= gather_byte(xa, xb, ab, ay + tap / 3 - 1, ax + tap % 3 - 1, c, H, W)
                         << (8 * (j & 3));
          }
        }
      }
      *reinterpret_cast<uint4*>(dA) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    for (int i = tid; i < BN * 2; i += kThreads) {
      const int row = i >> 1, half = i & 1;
      const int n = n0 + row;
      int8_t* dB = &sB[stage][row * kPitch + half * 16];
      if (kVec) {
        const bool ok = n < N;
        cp_async16(dB, ok ? w + static_cast<long>(n) * K + kt * kBK + half * 16 : w, ok);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (n < N) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int k = kt * kBK + half * 16 + j;
            if (k < K)
              v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                               w[static_cast<long>(n) * K + k]))
                           << (8 * (j & 3));
          }
        }
        *reinterpret_cast<uint4*>(dB) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  int acc[2][kNI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();  // slice kt is in; every warp is done with slice kt - 1
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk);
    cp_commit();

    const int8_t* a = sA[kt % kStages];
    const int8_t* b = sB[kt % kStages];
    uint32_t af[2][4], bfr[kNI][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      af[mi][0] = lds32(a + r * kPitch + t4 * 4);
      af[mi][1] = lds32(a + (r + 8) * kPitch + t4 * 4);
      af[mi][2] = lds32(a + r * kPitch + 16 + t4 * 4);
      af[mi][3] = lds32(a + (r + 8) * kPitch + 16 + t4 * 4);
    }
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
      const int n = wn * kWN + ni * 8 + g;
      bfr[ni][0] = lds32(b + n * kPitch + t4 * 4);
      bfr[ni][1] = lds32(b + n * kPitch + 16 + t4 * 4);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
  }

  // epilogue: accumulator (row g or g + 8, columns 2 t4 and 2 t4 + 1) of each tile
  float mul[kNI][2], add[kNI][2];
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + wn * kWN + ni * 8 + t4 * 2 + j;
      mul[ni][j] = n < N ? load_param<kBf16>(mult, n) : 0.f;
      add[ni][j] = n < N ? load_param<kBf16>(bias, n) : 0.f;
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long m = m0 + wm * 32 + mi * 16 + g + h * 8;
      if (m >= M) continue;
      int8_t* row = out + m * N;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int n = n0 + wn * kWN + ni * 8 + t4 * 2;
        const int8_t q0 = requant<kBf16>(acc[mi][ni][h * 2], mul[ni][0], add[ni][0]);
        const int8_t q1 = requant<kBf16>(acc[mi][ni][h * 2 + 1], mul[ni][1], add[ni][1]);
        if ((N & 1) == 0 && n + 1 < N) {
          char2 q;
          q.x = q0;
          q.y = q1;
          *reinterpret_cast<char2*>(row + n) = q;
        } else {
          if (n < N) row[n] = q0;
          if (n + 1 < N) row[n + 1] = q1;
        }
      }
    }
}

template <int BN, bool kVec>
cudaError_t launch_sync(bool bf16, Src xa, Src xb, const int8_t* w, const void* mult,
                   const void* bias, int8_t* out, int B, int H, int W, int N,
                   cudaStream_t stream) {
  const long M = static_cast<long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), (N + BN - 1) / BN);
  if (bf16)
    qconv_sync_kernel<BN, kVec, true><<<grid, kThreads, 0, stream>>>(xa, xb, w, mult, bias, out,
                                                                B, H, W, N);
  else
    qconv_sync_kernel<BN, kVec, false><<<grid, kThreads, 0, stream>>>(xa, xb, w, mult, bias, out,
                                                                 B, H, W, N);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bn(bool vec, bool bf16, Src xa, Src xb, const int8_t* w, const void* mult,
                      const void* bias, int8_t* out, int B, int H, int W, int N,
                      cudaStream_t stream) {
  return vec ? launch_sync<BN, true>(bf16, xa, xb, w, mult, bias, out, B, H, W, N, stream)
             : launch_sync<BN, false>(bf16, xa, xb, w, mult, bias, out, B, H, W, N, stream);
}

// -- the c3 route: one source of 3 channels (conv0_0.conv1)

namespace c3 {

constexpr int kRows = 2;                        // output rows of a block
constexpr int kCols = 64;                       // output columns of a block
constexpr int kBN = 32;                         // output channels of a block
constexpr int kChunks = 3 * kCols / 16 + 2;     // 16-byte chunks of a halo row
constexpr int kHaloPitch = 16 * kChunks;        // 224 bytes
constexpr int kLeft = 16 - 3;                   // halo byte of input column x0 - 1
constexpr int kW = kBN * 27;                    // a block's weight bytes: 864
static_assert(kRows * kCols == kBM, "the mma.sync route's 128-pixel warp layout");
static_assert((kRows + 2) * kChunks <= 64 && 64 + kW / 16 <= kThreads, "one copy a thread");
static_assert((3 * kCols) % 16 == 0 && kW % 16 == 0, "aligned chunks");

// bytes K0 .. K0 + 15 of a 32-byte K row whose byte k is rows[k / 9][k % 9]
// for k < 27 and 0 after: three runs of 9 bytes (k = 9 dy + 3 dx + c)
template <int K0>
__device__ __forceinline__ uint4 k_bytes(const int8_t* const (&rows)[3]) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = K0 + j;
    if (k < 27)
      v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(rows[k / 9][k % 9]))
                   << (8 * (j & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    qconv_c3_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const void* mult, const void* bias, int8_t* __restrict__ out, int H,
                    int W, int N) {
  __shared__ __align__(16) int8_t sHalo[(kRows + 2) * kHaloPitch];
  __shared__ __align__(16) int8_t sW[kW];
  __shared__ __align__(16) int8_t sA[kBM * kPitch];  // the A tile, then the int8 output tile
  __shared__ __align__(16) int8_t sB[kBN * kPitch];

  const int tiles_x = (W + kCols - 1) / kCols, tiles_y = (H + kRows - 1) / kRows;
  const int tx = blockIdx.x % tiles_x, rest = blockIdx.x / tiles_x;
  const int ty = rest % tiles_y, b = rest / tiles_y;
  const int x0 = tx * kCols, y0 = ty * kRows, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const long row_bytes = 3L * W;

  // 1. halo rows y0 - 1 .. y0 + kRows, bytes 3 x0 - 16 .. 3 (x0 + kCols) + 15
  //    of each; rows outside this image and bytes outside the row are zeros.
  //    Then the block's weights, rows n0 .. n0 + 31 of the (N, 27) matrix.
  if (tid < (kRows + 2) * kChunks) {
    const int hr = tid / kChunks, j = tid % kChunks;
    const int y = y0 - 1 + hr;
    const long bx = 3L * x0 - 16 + 16 * j;
    const bool ok = y >= 0 && y < H && bx >= 0 && bx < row_bytes;
    cp_async16(sHalo + hr * kHaloPitch + 16 * j,
               ok ? x + (static_cast<long>(b) * H + y) * row_bytes + bx : x, ok);
  } else if (tid >= 64 && tid < 64 + kW / 16) {
    const int q = tid - 64;
    cp_async16(sW + 16 * q, w + static_cast<long>(n0) * 27 + 16 * q, true);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // 2. the A tile: pixel p = tid % 128 (row p / kCols, column p % kCols of
  //    the block), bytes 16 h .. 16 h + 15 of its K row (h = tid / 128, the
  //    same for a whole warp); the B tile from the first two warps
  {
    const int p = tid & (kBM - 1);
    const int8_t* const at = sHalo + (p / kCols) * kHaloPitch + kLeft + 3 * (p % kCols);
    const int8_t* const rows[3] = {at, at + kHaloPitch, at + 2 * kHaloPitch};
    uint4* dst = reinterpret_cast<uint4*>(sA + p * kPitch + 16 * (tid >> 7));
    if (tid < kBM)
      *dst = k_bytes<0>(rows);
    else
      *dst = k_bytes<16>(rows);
  }
  if (tid < 2 * kBN) {
    const int n = tid & (kBN - 1);
    const int8_t* const rows[3] = {sW + n * 27, sW + n * 27 + 9, sW + n * 27 + 18};
    uint4* dst = reinterpret_cast<uint4*>(sB + n * kPitch + 16 * (tid >> 5));
    if (tid < kBN)
      *dst = k_bytes<0>(rows);
    else
      *dst = k_bytes<16>(rows);
  }
  __syncthreads();

  // 3. one k32 step: the mma.sync route's warp layout and fragments
  constexpr int kWN = kBN / 2, kNI = kWN / 8;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  int acc[2][kNI][4];
  uint32_t af[2][4], bfr[kNI][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = wm * 32 + mi * 16 + g;
    af[mi][0] = lds32(sA + r * kPitch + t4 * 4);
    af[mi][1] = lds32(sA + (r + 8) * kPitch + t4 * 4);
    af[mi][2] = lds32(sA + r * kPitch + 16 + t4 * 4);
    af[mi][3] = lds32(sA + (r + 8) * kPitch + 16 + t4 * 4);
  }
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni) {
    const int n = wn * kWN + ni * 8 + g;
    bfr[ni][0] = lds32(sB + n * kPitch + t4 * 4);
    bfr[ni][1] = lds32(sB + n * kPitch + 16 + t4 * 4);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
      mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
  __syncthreads();  // every warp holds its fragments: the A tile's space takes the output

  // 4. the epilogue into shared memory: rows g and g + 8 of each 16-row
  //    tile, columns 2 t4 and 2 t4 + 1 of each n8 tile
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni) {
    const int n = wn * kWN + ni * 8 + t4 * 2;
    const float mu0 = load_param<kBf16>(mult, n0 + n), mu1 = load_param<kBf16>(mult, n0 + n + 1);
    const float b0 = load_param<kBf16>(bias, n0 + n), b1 = load_param<kBf16>(bias, n0 + n + 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        char2 q;
        q.x = requant<kBf16>(acc[mi][ni][h * 2], mu0, b0);
        q.y = requant<kBf16>(acc[mi][ni][h * 2 + 1], mu1, b1);
        *reinterpret_cast<char2*>(sA + (wm * 32 + mi * 16 + g + h * 8) * kPitch + n) = q;
      }
  }
  __syncthreads();

  // 5. 16-byte stores: thread tid writes half tid % 2 of pixel tid / 2's 32 bytes
  {
    const int p = tid >> 1, c = tid & 1;
    const int y = y0 + p / kCols, xx = x0 + p % kCols;
    if (y < H && xx < W)
      *reinterpret_cast<uint4*>(out + ((static_cast<long>(b) * H + y) * W + xx) * N + n0 +
                                16 * c) = *reinterpret_cast<const uint4*>(sA + p * kPitch + 16 * c);
  }
}

cudaError_t launch_c3(bool bf16, const int8_t* x, const int8_t* w, const void* mult,
                      const void* bias, int8_t* out, int B, int H, int W, int N,
                      cudaStream_t stream) {
  const long tiles = static_cast<long>(B) * ((H + kRows - 1) / kRows) * ((W + kCols - 1) / kCols);
  const dim3 grid(static_cast<unsigned>(tiles), N / kBN);
  if (bf16)
    qconv_c3_kernel<true><<<grid, kThreads, 0, stream>>>(x, w, mult, bias, out, H, W, N);
  else
    qconv_c3_kernel<false><<<grid, kThreads, 0, stream>>>(x, w, mult, bias, out, H, W, N);
  return cudaGetLastError();
}

}  // namespace c3

// -- the wgmma route: every source's channel count a multiple of 32

namespace wg {

constexpr int kBM = 128;      // output pixels of a block: 2 warpgroups x 64 rows
constexpr int kBK = 128;      // K bytes of a stage: 4 wgmma k32 steps, one 128-byte row
constexpr int kStages = 4;    // ring depth; loads run kStages - 2 slices ahead
constexpr int kThreads = 256;

template <int BN>
struct Tile {
  static constexpr int kA = kBM * kBK;          // bytes of a stage's A tile (then B)
  static constexpr int kStage = kA + BN * kBK;
  static constexpr int kPitch = BN + 16;        // epilogue tile row, 16-byte aligned
  static constexpr int kSmem = kStages * kStage + 1024;  // + room to align the ring to 1 KiB
  static_assert(kBM * kPitch <= kStages * kStage, "the epilogue tile reuses the ring");
};

// byte offset of 16-byte chunk j of row r in a 128-byte-swizzled tile: 8-row
// atoms of 1 KiB, chunk j of row r stored at chunk j ^ (r & 7) (the hardware's
// Swizzle<3,4,3> on address bits [4,7) ^ [7,10), so the ring is 1 KiB aligned)
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * kBK + ((j ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor of a K-major operand in that layout: start
// address >> 4, stride between 8-row atoms (SBO) 1024 bytes, layout 128-byte
// swizzle; the leading offset is unused for a swizzled K-major operand
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps nvcc from moving accumulator reads or writes across the async wgmma
template <int R>
__device__ __forceinline__ void acc_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N int32 tile of the warpgroup) += A (64 x 32, da) . B (N x 32, db)^T
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    wgmma_n128(d, da, db);
  else if constexpr (BN == 64)
    wgmma_n64(d, da, db);
  else
    wgmma_n32(d, da, db);
}

template <int BN, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    qconv_wgmma_kernel(Src xa, Src xb, const int8_t* __restrict__ w, const void* mult,
                       const void* bias, int8_t* __restrict__ out, int B, int H, int W,
                       int N) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // shared address of stage 0
  int8_t* const ring_ptr = reinterpret_cast<int8_t*>(smem_raw + (ring - raw));

  const int C = xa.c + xb.c;
  const int K = 9 * C;
  const int KT = (K + kBK - 1) / kBK;
  const long M = static_cast<long>(B) * H * W;
  const int ntiles = N / BN;  // the N tiles of one M tile are neighbours in the grid
  const long m0 = static_cast<long>(blockIdx.x / ntiles) * kBM;
  const int n0 = static_cast<int>(blockIdx.x % ntiles) * BN;
  const int tid = threadIdx.x;

  // loads: thread tid fills 16-byte chunk j of rows r0 + 32 i of A (4 rows)
  // and of B (BN / 32 rows); the chunk's k = kt * 128 + 16 j names one tap
  // and one source, as every source's channel count is a multiple of 32
  const int j = tid & 7, r0 = tid >> 3;
  int py[4], px[4];
  bool pin[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long m = m0 + r0 + 32 * i;
    pin[i] = m < M;
    px[i] = static_cast<int>(m % W);
    py[i] = static_cast<int>((m / W) % H);
  }

  auto load_stage = [&](int stage, int kt) {
    int8_t* const sa = ring_ptr + stage * T::kStage;
    int8_t* const sb = sa + T::kA;
    const int k = kt * kBK + 16 * j;
    const bool kin = k < K;  // the K tail (K = 9 C is a multiple of 32, not 128) is zero
    const int tap = kin ? k / C : 0;
    const int c = k - tap * C;
    const bool first = c < xa.c;
    const int8_t* const p = first ? xa.p : xb.p;
    const int cs = first ? xa.c : xb.c, cc = first ? c : c - xa.c;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = py[i] + dy, ix = px[i] + dx;
      const bool ok = kin && pin[i] && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const long pix = m0 + r0 + 32 * i + static_cast<long>(dy) * W + dx;
      cp_async16(sa + swz(r0 + 32 * i, j), ok ? p + pix * cs + cc : xa.p, ok);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int n = r0 + 32 * i;
      cp_async16(sb + swz(n, j), kin ? w + static_cast<long>(n0 + n) * K + k : w, kin);
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t a_rows = (tid >> 7) * 64 * kBK;  // this warpgroup's 64 rows of A

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < KT) load_stage(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<kStages - 3>();  // this thread's copies of slice kt have landed
    fence_proxy_async();     // ... and are visible to wgmma's async proxy
    __syncthreads();         // every thread's copies of slice kt; group kt - 2 retired
    const int nk = kt + kStages - 2;  // refill stage (kt - 2) % kStages
    if (nk < KT) load_stage(nk % kStages, nk);
    cp_commit();

    const uint32_t sa = ring + (kt % kStages) * T::kStage;
    wgmma_fence();
    acc_fence(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma<BN>(acc, desc(sa + a_rows + 32 * kk), desc(sa + T::kA + 32 * kk));
    wgmma_commit();
    acc_fence(acc);
    wgmma_wait<1>();  // group kt - 1 retired before the next barrier lets its stage refill
    acc_fence(acc);
  }
  wgmma_wait<0>();
  acc_fence(acc);
  cp_wait<0>();
  __syncthreads();  // both warpgroups are done with the ring: it holds the output tile now

  // epilogue: thread (warp w of its warpgroup, lane 4 g + t4) holds rows
  // 16 w + g and 16 w + g + 8 of its warpgroup's 64, columns 8 i + 2 t4 and
  // 8 i + 2 t4 + 1 of each n8 tile i (the mma.sync indexing)
  {
    const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int row = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = 8 * i + 2 * t4;
      const float mu0 = load_param<kBf16>(mult, n0 + n), mu1 = load_param<kBf16>(mult, n0 + n + 1);
      const float b0 = load_param<kBf16>(bias, n0 + n), b1 = load_param<kBf16>(bias, n0 + n + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        char2 q;
        q.x = requant<kBf16>(acc[4 * i + 2 * h], mu0, b0);
        q.y = requant<kBf16>(acc[4 * i + 2 * h + 1], mu1, b1);
        *reinterpret_cast<char2*>(ring_ptr + (row + 8 * h) * T::kPitch + n) = q;
      }
    }
  }
  __syncthreads();
  // the int8 tile in 16-byte rows: consecutive threads, consecutive bytes of a row
  constexpr int kChunks = BN / 16;
#pragma unroll
  for (int it = 0; it < kBM * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const long m = m0 + r;
    if (m < M)
      *reinterpret_cast<uint4*>(out + m * N + n0 + 16 * c) =
          *reinterpret_cast<const uint4*>(ring_ptr + r * T::kPitch + 16 * c);
  }
}

template <int BN>
cudaError_t launch_wgmma(bool bf16, Src xa, Src xb, const int8_t* w, const void* mult,
                         const void* bias, int8_t* out, int B, int H, int W, int N,
                         cudaStream_t stream) {
  const long M = static_cast<long>(B) * H * W;
  const long blocks = (M + kBM - 1) / kBM * (N / BN);
  auto kernel = bf16 ? qconv_wgmma_kernel<BN, true> : qconv_wgmma_kernel<BN, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<BN>::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, Tile<BN>::kSmem, stream>>>(
      xa, xb, w, mult, bias, out, B, H, W, N);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// The wrapper (qconv_kernels.qconv) has checked shapes, types, devices and
// contiguity and picked the route and the tile width (`qconv_kernels.route`).
// xb may be null when cb == 0. Each returns the launch's cudaGetLastError(),
// or cudaErrorInvalidValue for a shape or tile width its kernel does not take.

// The c3 kernel: one source x (B, H, W, 3), N a multiple of 32, 3 W a
// multiple of 16, x, w and out 16-byte aligned.
extern "C" int qconv_s8_c3(const void* x, const void* w, const void* mult, const void* bias,
                           int bf16, void* out, int B, int H, int W, int N, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out);
  if (B <= 0 || H <= 0 || W <= 0 || N <= 0 || N % c3::kBN != 0 || N / c3::kBN > 65535 ||
      (3 * W) % 16 != 0 || (align & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(c3::launch_c3(bf16 != 0, static_cast<const int8_t*>(x),
                                        static_cast<const int8_t*>(w), mult, bias,
                                        static_cast<int8_t*>(out), B, H, W, N,
                                        static_cast<cudaStream_t>(stream)));
}

// The mma.sync kernel, any shape: bn 32, 64 or 128; `vec` != 0 only when
// ca and cb are multiples of 32 and both sources and the weights are 16-byte
// aligned (16-byte copies; else the byte path).
extern "C" int qconv_s8_sync(const void* xa, int ca, const void* xb, int cb, const void* w,
                             const void* mult, const void* bias, int bf16, void* out, int B,
                             int H, int W, int N, int bn, int vec, void* stream) {
  const Src sa{static_cast<const int8_t*>(xa), ca};
  const Src sb{xb ? static_cast<const int8_t*>(xb) : static_cast<const int8_t*>(xa), cb};
  const int8_t* wq = static_cast<const int8_t*>(w);
  int8_t* o = static_cast<int8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bn == 128)
    err = launch_bn<128>(vec != 0, bf16 != 0, sa, sb, wq, mult, bias, o, B, H, W, N, s);
  else if (bn == 64)
    err = launch_bn<64>(vec != 0, bf16 != 0, sa, sb, wq, mult, bias, o, B, H, W, N, s);
  else if (bn == 32)
    err = launch_bn<32>(vec != 0, bf16 != 0, sa, sb, wq, mult, bias, o, B, H, W, N, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The wgmma kernel: ca and cb multiples of 32, N a multiple of bn (32, 64 or
// 128), the sources, the weights and the output 16-byte aligned.
extern "C" int qconv_s8_wgmma(const void* xa, int ca, const void* xb, int cb, const void* w,
                              const void* mult, const void* bias, int bf16, void* out, int B,
                              int H, int W, int N, int bn, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(xa) | reinterpret_cast<uintptr_t>(xb) |
                          reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(out);
  if (ca % 32 != 0 || cb % 32 != 0 || ca + cb == 0 || bn <= 0 || N % bn != 0 || (align & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const Src sa{static_cast<const int8_t*>(xa), ca};
  const Src sb{xb ? static_cast<const int8_t*>(xb) : static_cast<const int8_t*>(xa), cb};
  const int8_t* wq = static_cast<const int8_t*>(w);
  int8_t* o = static_cast<int8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bn == 128)
    err = wg::launch_wgmma<128>(bf16 != 0, sa, sb, wq, mult, bias, o, B, H, W, N, s);
  else if (bn == 64)
    err = wg::launch_wgmma<64>(bf16 != 0, sa, sb, wq, mult, bias, o, B, H, W, N, s);
  else if (bn == 32)
    err = wg::launch_wgmma<32>(bf16 != 0, sa, sb, wq, mult, bias, o, B, H, W, N, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
