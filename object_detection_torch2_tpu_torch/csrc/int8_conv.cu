// The int8 convolution of the quantized SSD layers for Hopper: s8 x s8 -> s32
// on the int8 tensor cores, with the per-channel dequantization and the bias
// fused into the epilogue.
//
// Not a TPU kernel: the JAX package computes this function with
// jax.lax.conv_general_dilated(..., preferred_element_type=int32)
// (object_detection_torch2_tpu/models/quant.py::int8_conv) followed by the
// dequantization of models/ssd.py (_conv_bn_relu_q, _head_conv_q), all XLA.
// Stock PyTorch has no CUDA int8 convolution, so the port has this kernel of
// its own. It computes what ops/int8_conv.py::int8_conv_plain computes, on
// NHWC int8 activations (channels_last) and int8 weights packed K-contiguous
// as (Cout, kh, kw, Cin):
//
//   acc[n, ho, wo, co] = sum_{r, c, ci} x[n, ho*s - p + r, wo*s - p + c, ci] * w[co, r, c, ci]
//
// exactly, in int32 (zero outside the image). Modes of the output:
//   0 raw:      y = acc (int32);
//   1 float32:  y = __fadd_rn(__fmul_rn(float(acc), scale[co]), bias[co]);
//   2 bfloat16: y = bf16(float(bf16(float(acc) * scale[co])) + float(bias[co])),
// where scale = sx * sw is one float32 vector computed by the caller first, as
// JAX writes (y32 * (sx * sw)).astype(dtype) + bias.astype(dtype). The
// explicit _rn intrinsics keep nvcc from contracting the float32 multiply and
// add into an FMA, so the kernel and the plain PyTorch version round the same
// way, bit for bit. bias may be null (no add).
//
// What bounds it on this card: the quantized trunk convs (blocks 2-5) of one
// batch-32 300x300 forward are 1.56 T int8 operations, 0.79 ms at the 1,979
// TOP/s dense int8 rate, against 1.17 GB of int8 inputs and weights and
// bfloat16 outputs (0.35 ms at 3.35 TB/s): bound by operations at these
// shapes. The small late layers (extras, heads at 1x1 to 10x10) are bound by
// neither, but by launch and tile waste.
//
// Design (a simple, correct first kernel; an implicit GEMM on mma.sync):
// - GEMM view: M = N*Ho*Wo output pixels, Ncol = Cout, K = kh*kw*Cin. One
//   block of 256 threads (8 warps as 2 x 4) computes a 128 x 128 output tile;
//   a warp owns 64 x 32 of it: 4 x 4 mma.sync.m16n8k32 s8 tiles, 64 int32
//   accumulators in registers.
// - K goes in steps of 32 bytes. Cin is a multiple of 32 for every quantized
//   layer, so a step never straddles a tap: its 32 input channels of one tap
//   are one contiguous 32-byte run of the NHWC input (or all zero, for a tap
//   in the padding or a row past M).
// - A 3-stage cp.async ring stages each step's A (128 pixels x 32 bytes) and
//   B (128 output channels x 32 bytes) tiles in shared memory, rows padded to
//   48 bytes so that the fragment loads (4 bytes per thread, 8 rows x 4
//   threads) hit 32 distinct banks. Zero-fill (src-size 0) is the padding and
//   the ragged edges of M and Cout.
// - Each thread decomposes its staging row's pixel (n, ho, wo) once, and
//   walks the taps incrementally, so the K loop does no division.
// - Bounds on M and Cout at the store: Cout may be 100 or 150 (the heads) and
//   Ho*Wo may be 1 (layer 11_2).
// Later work (not here): wgmma with TMA, a persistent tile walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output pixels of a block's tile
constexpr int BN = 128;          // output channels of a block's tile
constexpr int BK = 32;           // bytes of K per step (one mma k32)
constexpr int LDS = 48;          // bytes per staged row: 32 + 16 of padding against bank conflicts
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int STAGE_BYTES = (BM + BN) * LDS;  // 12,288: A rows then B rows

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Shape {
  int n, h, w, cin, cout, kh, kw, stride, pad, ho, wo;
};

template <int MODE>
__global__ void __launch_bounds__(THREADS) int8_conv_kernel(const int8_t* __restrict__ x,
                                                             const int8_t* __restrict__ wt,
                                                             const float* __restrict__ scale,
                                                             const void* __restrict__ bias, void* __restrict__ y,
                                                             Shape sh, int ntiles) {
  __shared__ __align__(128) int8_t smem[STAGES * STAGE_BYTES];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const int wm = warp & 1, wn = warp >> 1;   // the warp's 64 x 32 sub-tile
  const int nt = blockIdx.x % ntiles;        // consecutive blocks share an A tile (L2)
  const int mt = blockIdx.x / ntiles;
  const long long m_total = static_cast<long long>(sh.n) * sh.ho * sh.wo;
  const long long m0 = static_cast<long long>(mt) * BM;
  const int n0 = nt * BN;
  const int k_total = sh.kh * sh.kw * sh.cin;
  const int ktiles = k_total / BK;

  // staging role: A row / B row `row`, 16-byte half `half`
  const int row = tid >> 1, half = tid & 1;
  const long long m = m0 + row;
  const bool m_ok = m < m_total;
  int hi0 = 0, wi0 = 0;
  const int8_t* ximg = x;
  if (m_ok) {
    const long long hw = static_cast<long long>(sh.ho) * sh.wo;
    const long long img = m / hw;
    const int rem = static_cast<int>(m - img * hw);
    hi0 = (rem / sh.wo) * sh.stride - sh.pad;
    wi0 = (rem % sh.wo) * sh.stride - sh.pad;
    ximg = x + img * sh.h * sh.w * sh.cin;
  }
  const bool n_ok = n0 + row < sh.cout;
  const int8_t* wrow = wt + static_cast<long long>(n_ok ? n0 + row : 0) * k_total + half * 16;
  int tap_r = 0, tap_c = 0, ci = 0;  // the next K step to stage: tap (r, c), channels ci..ci+31

  auto stage = [&](int slot, int kt) {
    int8_t* as = smem + slot * STAGE_BYTES;
    int8_t* bs = as + BM * LDS;
    const int hi = hi0 + tap_r, wi = wi0 + tap_c;
    const bool a_ok = m_ok && hi >= 0 && hi < sh.h && wi >= 0 && wi < sh.w;
    const int8_t* asrc = a_ok ? ximg + (static_cast<long long>(hi) * sh.w + wi) * sh.cin + ci + half * 16 : x;
    cp_async16(as + row * LDS + half * 16, asrc, a_ok);
    cp_async16(bs + row * LDS + half * 16, n_ok ? wrow + kt * BK : wt, n_ok);
    ci += BK;
    if (ci == sh.cin) {
      ci = 0;
      if (++tap_c == sh.kw) {
        tap_c = 0;
        ++tap_r;
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed
    __syncthreads();              // ... for every thread, and step kt-1's slot is free
    const int next = kt + STAGES - 1;
    if (next < ktiles) stage(next % STAGES, next);
    cp_async_commit();

    const int8_t* as = smem + (kt % STAGES) * STAGE_BYTES;
    const int8_t* bs = as + BM * LDS;
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int8_t* p = as + (wm * 64 + i * 16 + g) * LDS + tig * 4;
      af[i][0] = lds32(p);
      af[i][1] = lds32(p + 8 * LDS);
      af[i][2] = lds32(p + 16);
      af[i][3] = lds32(p + 8 * LDS + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* p = bs + (wn * 32 + j * 8 + g) * LDS + tig * 4;
      bf[j][0] = lds32(p);
      bf[j][1] = lds32(p + 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();

  // epilogue: accumulator (i, j, e) is output pixel m0 + wm*64 + i*16 + g (+8
  // for e >= 2), channel n0 + wn*32 + j*8 + 2*tig + (e & 1)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int co = n0 + wn * 32 + j * 8 + 2 * tig + e2;
      if (co >= sh.cout) continue;
      float s = 0.f;
      if (MODE != 0) s = scale[co];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const long long mo = m0 + wm * 64 + i * 16 + g + 8 * e1;
          if (mo >= m_total) continue;
          const int v = acc[i][j][2 * e1 + e2];
          const long long off = mo * sh.cout + co;
          if (MODE == 0) {
            static_cast<int*>(y)[off] = v;
          } else if (MODE == 1) {
            float r = __fmul_rn(__int2float_rn(v), s);
            if (bias != nullptr) r = __fadd_rn(r, static_cast<const float*>(bias)[co]);
            static_cast<float*>(y)[off] = r;
          } else {
            __nv_bfloat16 r = __float2bfloat16_rn(__fmul_rn(__int2float_rn(v), s));
            if (bias != nullptr)
              r = __float2bfloat16_rn(
                  __fadd_rn(__bfloat162float(r), __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[co])));
            static_cast<__nv_bfloat16*>(y)[off] = r;
          }
        }
      }
    }
  }
}

}  // namespace

// x (n, h, w, cin) int8; w (cout, kh, kw, cin) int8; scale (cout,) float32 or
// null in mode 0; bias (cout,) float32 (mode 1) or bfloat16 (mode 2) or null;
// y (n, ho, wo, cout) of the mode's type. Returns cudaGetLastError() after the
// launch (0 when it was accepted), or an error code for arguments the kernel
// does not take. Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int int8_conv_forward(const void* x, const void* w, const float* scale, const void* bias, void* y,
                                 int n, int h, int wd, int cin, int cout, int kh, int kw, int stride, int pad,
                                 int mode, cudaStream_t stream) {
  if (n < 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || pad < 0 ||
      cin % BK != 0 || mode < 0 || mode > 2 || (mode != 0 && scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh{n, h, wd, cin, cout, kh, kw, stride, pad, (h + 2 * pad - kh) / stride + 1, (wd + 2 * pad - kw) / stride + 1};
  if (sh.ho <= 0 || sh.wo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long m_total = static_cast<long long>(n) * sh.ho * sh.wo;
  if (m_total == 0) return 0;
  const long long mtiles = (m_total + BM - 1) / BM;
  const int ntiles = (cout + BN - 1) / BN;
  if (mtiles * ntiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(mtiles * ntiles));
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  if (mode == 0)
    int8_conv_kernel<0><<<grid, THREADS, 0, stream>>>(xs, ws, scale, bias, y, sh, ntiles);
  else if (mode == 1)
    int8_conv_kernel<1><<<grid, THREADS, 0, stream>>>(xs, ws, scale, bias, y, sh, ntiles);
  else
    int8_conv_kernel<2><<<grid, THREADS, 0, stream>>>(xs, ws, scale, bias, y, sh, ntiles);
  return static_cast<int>(cudaGetLastError());
}
