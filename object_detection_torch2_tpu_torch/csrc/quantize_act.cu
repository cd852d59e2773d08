// The activation quantize of the int8 layers, one pass: x (bfloat16 or
// float32) -> int8 = clamp(round_half_even(x / sx), -127, 127), with sx one
// float32 scale read on the card (no host sync).
//
// Not a TPU kernel: the JAX package writes this as elementwise jnp ops
// (object_detection_torch2_tpu/models/quant.py::quantize_act) that XLA fuses
// into the producer of the conv input. The port's plain version,
// models/quant.py::quantize_act, is five PyTorch passes (to float32, divide,
// round, clamp, to int8) that move ~35 bytes per bfloat16 element; this
// kernel is their fusion, the counterpart of XLA's.
//
// Two division contexts, both kept bit for bit:
//   reciprocal = 0 (serving): q = __fdiv_rn(x, sx), a true IEEE division;
//   reciprocal = 1 (Trainer):  q = __fmul_rn(x, __frcp_rn(sx)), the JAX
//     Trainer's constant-folded x * float32(1 / sx).
// Then rintf (round half to even, as torch.round), the clamp, the cast. A
// NaN input has no defined int8 (the plain version's cast leaves it
// undefined too); +-inf and values beyond +-127 sx saturate, -0.0 gives 0.
//
// What bounds it on this card: bytes. Each element is read once (2 or 4
// bytes) and written once (1 byte): the inputs of blocks 2-5 at batch 32,
// 300x300 in bfloat16 are 330 M elements, 0.99 GB, 0.296 ms at 3.35 TB/s.
// Design: a grid-stride loop over 16-element groups, each two (bfloat16)
// or four (float32) 16-byte loads and one 16-byte store; a scalar tail.
// The layout does not matter (the wrapper takes channels_last tensors, whose
// memory is dense), so the pass is flat.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int8_t quantize(float v, float sx, float rcp, int reciprocal) {
  const float q = rintf(reciprocal ? __fmul_rn(v, rcp) : __fdiv_rn(v, sx));
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(q, -127.0f), 127.0f)));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// four int8 results in one word, element 0 in the low byte
__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(a)) | (static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16) | (static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24);
}
// the two bfloat16 of a word as float32 (exact: a bfloat16 is a float32's upper half)
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

template <typename T>
__global__ void __launch_bounds__(THREADS) quantize_act_kernel(const T* __restrict__ x, const float* __restrict__ sx_ptr,
                                                               int8_t* __restrict__ y, long long n, int reciprocal) {
  const float sx = *sx_ptr;
  const float rcp = __frcp_rn(sx);
  const long long groups = n / 16;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  auto q = [&](float v) { return quantize(v, sx, rcp, reciprocal); };
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups; g += step) {
    const uint4* src = reinterpret_cast<const uint4*>(x + g * 16);
    uint32_t out[4];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const uint4 r = src[l];
        out[l] = pack4(q(__uint_as_float(r.x)), q(__uint_as_float(r.y)), q(__uint_as_float(r.z)),
                       q(__uint_as_float(r.w)));
      }
    } else {
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const uint4 r = src[l];
        out[2 * l] = pack4(q(bf_lo(r.x)), q(bf_hi(r.x)), q(bf_lo(r.y)), q(bf_hi(r.y)));
        out[2 * l + 1] = pack4(q(bf_lo(r.z)), q(bf_hi(r.z)), q(bf_lo(r.w)), q(bf_hi(r.w)));
      }
    }
    *reinterpret_cast<uint4*>(y + g * 16) = make_uint4(out[0], out[1], out[2], out[3]);
  }
  // the last n % 16 elements
  const long long tail = groups * 16 + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tail < n) y[tail] = quantize(to_float(x[tail]), sx, rcp, reciprocal);
}

}  // namespace

// x: n elements, bfloat16 (dtype 1) or float32 (dtype 0), 16-byte aligned;
// sx: one float32 on the card; y: n int8, 16-byte aligned. Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() after the launch (0 when it was accepted), or an error
// code for arguments it does not take.
extern "C" int quantize_act_forward(const void* x, const float* sx, void* y, long long n, int dtype, int reciprocal,
                                    cudaStream_t stream) {
  if (n < 0 || (dtype != 0 && dtype != 1) || sx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = n / 16;
  long long blocks = (groups + THREADS - 1) / THREADS;
  if (blocks > 8LL * sms) blocks = 8LL * sms;  // a grid-stride loop past 8 blocks an SM
  if (blocks < 1) blocks = 1;                  // the tail alone
  int8_t* out = static_cast<int8_t*>(y);
  if (dtype == 1) {
    quantize_act_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), sx, out, n, reciprocal);
  } else {
    quantize_act_kernel<float><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(static_cast<const float*>(x),
                                                                                     sx, out, n, reciprocal);
  }
  return static_cast<int>(cudaGetLastError());
}
