// conv_1_2 forward in float32 for Hopper: 3x3, stride 1, zero pad 1, 64 -> 64
// channels, plus bias.
//
// Replaces, for float32 input, the TPU kernel
// object_detection_torch2_tpu/ops/conv12_pallas.py::_kernel (reached through
// _conv12_pallas and conv12_paired); bfloat16 input goes to the tensor-core
// kernel csrc/conv12_bf16.cu. It computes what ops/conv12.py::conv12_plain
// computes, on channels_last (NHWC in memory) tensors:
//
//   y[n, co, h, w] = b[co] + sum_{ky,kx,ci} x[n, ci, h+ky-1, w+kx-1] * w[co, ci, ky, kx]
//
// with the sum and the bias in float32. The TPU's paired-x layout, its
// host-side edge operand and its weight packing are lane tricks of the TPU and
// are not carried over.
//
// What bounds it on this card, at the training path's shape (N 32, 300 x 300):
// 2*N*H*W*9*64*64 = 212.3 GFLOP against 2 x 184.3 M elements moved. The work
// runs on the CUDA cores (the TF32 tensor-core path would lose the parity the
// float32 forward is held to): 3.17 ms at 67 TFLOP/s, while the bytes
// (1.47 GB) take 0.44 ms, so it is bound by operations.
//
// Design (a simple, correct first kernel; an implicit GEMM on the CUDA cores):
// - One block of 256 threads computes a 16 x 16 tile of output pixels for all
//   64 output channels. Thread t owns 8 consecutive pixels of one tile row and
//   8 output channels (co = 4g..4g+3 and 32+4g..32+4g+3, g = t % 8), so a
//   warp's weight reads are one contiguous 128-byte row of shared memory and
//   its input reads hit four distinct banks, each broadcast to 8 threads.
// - The input channels go in 4 chunks of 16. For each chunk the block stages
//   the 18 x 18-pixel halo of the input (converted to float32, zero outside the
//   image) and the chunk's weights for all nine taps, repacked by the wrapper
//   to (ky, kx, ci, co) float32, in 57,600 B of dynamic shared memory (above
//   the 48 KB static limit, hence cudaFuncSetAttribute). Two blocks fit an SM.
// - Per (ky, ci) a thread reads 10 input values once and reuses them for the
//   three kx taps: 16 shared-memory loads feed 192 FMAs into 64 float32
//   accumulators in registers.
// - The ragged edge (300 is not a multiple of 16) is masked at the load (zero)
//   and at the store (skipped).
// Later work (not here): double-buffered staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;          // channels in and out
constexpr int TH = 16;         // output rows of a block's tile
constexpr int TW = 16;         // output columns of a block's tile
constexpr int HH = TH + 2;     // staged rows, with the halo
constexpr int HW = TW + 2;     // staged columns, with the halo
constexpr int CK = 16;         // input channels staged per chunk
constexpr int PX = 8;          // output pixels of a thread: one row, 8 consecutive columns
constexpr int THREADS = 256;   // 32 pixel groups x 8 channel groups
constexpr int S_IN = CK * HH * HW;  // staged input, [ci][row][col] float32
constexpr int S_W = 9 * CK * C;     // staged weights, [tap][ci][co] float32
constexpr size_t SMEM_BYTES = (S_IN + S_W) * sizeof(float);

__device__ __forceinline__ float to_f32(float v) { return v; }

// four float32 values to 4 consecutive outputs
__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv12_kernel(const T* __restrict__ x, const float* __restrict__ wpk, const float* __restrict__ bias,
              T* __restrict__ y, int H, int W) {
  extern __shared__ float4 smem4[];
  float* s_in = reinterpret_cast<float*>(smem4);  // [CK][HH][HW]
  float* s_w = s_in + S_IN;                       // [9][CK][C], 16-byte aligned (S_IN % 4 == 0)

  const int tid = threadIdx.x;
  const int cg = tid & 7;          // channel group
  const int pg = tid >> 3;         // pixel group, 0..31
  const int row = pg >> 1;         // tile row, 0..15
  const int col0 = (pg & 1) * PX;  // first tile column, 0 or 8
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const size_t n = blockIdx.z;
  const T* xn = x + n * H * W * C;

  float acc[PX][8];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // the previous chunk's reads are done
    // input halo: element i = (pixel, ci), ci fastest so a warp reads 2 pixels' chunks
    for (int i = tid; i < HH * HW * CK; i += THREADS) {
      const int ci = i % CK;
      const int pix = i / CK;
      const int hr = pix / HW;
      const int hc = pix % HW;
      const int gh = h0 + hr - 1;
      const int gw = w0 + hc - 1;
      float v = 0.0f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W) v = to_f32(xn[(static_cast<size_t>(gh) * W + gw) * C + c0 + ci]);
      s_in[(ci * HH + hr) * HW + hc] = v;
    }
    // weights of the chunk for all nine taps, 16 bytes a thread
    for (int i = tid; i < 9 * CK * (C / 4); i += THREADS) {
      const int co4 = i % (C / 4);
      const int rest = i / (C / 4);
      const int ci = rest % CK;
      const int tap = rest / CK;
      reinterpret_cast<float4*>(s_w)[(tap * CK + ci) * (C / 4) + co4] =
          reinterpret_cast<const float4*>(wpk)[(tap * C + c0 + ci) * (C / 4) + co4];
    }
    __syncthreads();

#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll 1
      for (int ci = 0; ci < CK; ++ci) {
        const float* src = s_in + (ci * HH + row + ky) * HW + col0;
        float a[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) a[j] = src[j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wr = reinterpret_cast<const float4*>(s_w + ((ky * 3 + kx) * CK + ci) * C);
          const float4 lo = wr[cg];
          const float4 hi = wr[8 + cg];
          const float b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p + kx], b[q], acc[p][q]);
        }
      }
    }
  }

  const int oh = h0 + row;
  if (oh >= H) return;
  float bl[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bl[q] = bias[cg * 4 + q];
    bl[4 + q] = bias[32 + cg * 4 + q];
  }
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ow = w0 + col0 + p;
    if (ow < W) {
      T* dst = y + ((n * H + oh) * W + ow) * C;
      store4(dst + cg * 4, acc[p][0] + bl[0], acc[p][1] + bl[1], acc[p][2] + bl[2], acc[p][3] + bl[3]);
      store4(dst + 32 + cg * 4, acc[p][4] + bl[4], acc[p][5] + bl[5], acc[p][6] + bl[6], acc[p][7] + bl[7]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* wpk, const float* bias, void* y, int n, int h, int w,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv12_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  conv12_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(static_cast<const T*>(x), wpk, bias,
                                                           static_cast<T*>(y), h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (n, 64, h, w) channels_last float32; wpk: (3, 3, 64 ci, 64 co)
// float32; bias: (64,) float32. Launches on `stream`, does not synchronise,
// and returns the launch's cudaGetLastError() (0 on success).
extern "C" int conv12_forward(const void* x, const float* wpk, const float* bias, void* y, int n, int h,
                              int w, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  if (n > 65535 || h > 65535 * TH) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch<float>(x, wpk, bias, y, n, h, w, stream);
}
