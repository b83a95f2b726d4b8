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
// weights once, the output written once) at 3.35 TB/s. The decoder's
// full-resolution layers (N = 32, M = B * 512^2) are bound by bytes, the
// deep ones by operations.
//
// Design (the simple first kernel; wgmma and TMA are later work): implicit
// GEMM, M = output pixels, N = output channels, K = 9 C, never an im2col.
// A block of 8 warps computes a 128 x BN tile (BN = 32, 64 or 128, the
// largest that divides N) with mma.sync m16n8k32 s8 -> s32; a warp owns 32
// rows x BN/2 columns. The K loop walks 32-value slices through a
// 3-stage cp.async ring in shared memory; rows are padded to 48 bytes so
// that the 32-bit fragment loads of a warp hit 32 distinct banks. When
// every source's channel count is a multiple of 32 (all layers but the
// first), a slice lies in one tap and one source, and a thread fetches its
// pixel's 16 bytes with one cp.async, zero-filled outside the plane (the
// conv's padding). Otherwise (Cin = 3 of conv0_0.conv1, ragged test shapes)
// a slice is gathered byte by byte, and the weights' tail is zero. The
// epilogue requantizes the accumulators in registers and stores int8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
    qconv_kernel(Src xa, Src xb, const int8_t* __restrict__ w, const void* mult,
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
cudaError_t launch(bool bf16, Src xa, Src xb, const int8_t* w, const void* mult,
                   const void* bias, int8_t* out, int B, int H, int W, int N,
                   cudaStream_t stream) {
  const long M = static_cast<long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), (N + BN - 1) / BN);
  if (bf16)
    qconv_kernel<BN, kVec, true><<<grid, kThreads, 0, stream>>>(xa, xb, w, mult, bias, out,
                                                                B, H, W, N);
  else
    qconv_kernel<BN, kVec, false><<<grid, kThreads, 0, stream>>>(xa, xb, w, mult, bias, out,
                                                                 B, H, W, N);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bn(bool vec, bool bf16, Src xa, Src xb, const int8_t* w, const void* mult,
                      const void* bias, int8_t* out, int B, int H, int W, int N,
                      cudaStream_t stream) {
  return vec ? launch<BN, true>(bf16, xa, xb, w, mult, bias, out, B, H, W, N, stream)
             : launch<BN, false>(bf16, xa, xb, w, mult, bias, out, B, H, W, N, stream);
}

}  // namespace

// The wrapper (qconv_kernels.qconv) has checked shapes, types, devices and
// contiguity. `vec` != 0 only when ca and cb are multiples of 32 and both
// sources and the weights are 16-byte aligned. xb may be null when cb == 0.
// Returns the launch's cudaGetLastError().
extern "C" int qconv_s8(const void* xa, int ca, const void* xb, int cb, const void* w,
                        const void* mult, const void* bias, int bf16, void* out, int B, int H,
                        int W, int N, int vec, void* stream) {
  const Src sa{static_cast<const int8_t*>(xa), ca};
  const Src sb{xb ? static_cast<const int8_t*>(xb) : static_cast<const int8_t*>(xa), cb};
  const int8_t* wq = static_cast<const int8_t*>(w);
  int8_t* o = static_cast<int8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N % 128 == 0)
    err = launch_bn<128>(vec != 0, bf16 != 0, sa, sb, wq, mult, bias, o, B, H, W, N, s);
  else if (N % 64 == 0)
    err = launch_bn<64>(vec != 0, bf16 != 0, sa, sb, wq, mult, bias, o, B, H, W, N, s);
  else
    err = launch_bn<32>(vec != 0, bf16 != 0, sa, sb, wq, mult, bias, o, B, H, W, N, s);
  return static_cast<int>(err);
}
