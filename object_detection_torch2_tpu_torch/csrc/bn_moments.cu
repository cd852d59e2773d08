// BatchNorm's batch moments as per-image partial sums: x (N, C, H, W) in
// bfloat16, float32 or float64 -> out (N, 2, C) float64, where row n is
//   [ sum_hw x[n, c, h, w],  sum_hw sq(x[n, c, h, w]) ]
// and sq is the square rounded in x's math dtype: float32 for bfloat16 and
// float32 inputs (as models/bn.py's `xf.square()` computes it), float64 for a
// float64 input. The square is __fmul_rn / __dmul_rn, so no FMA takes it into
// the float64 add; every add is in float64.
//
// Not a TPU kernel: the JAX package's BatchNormTPU
// (object_detection_torch2_tpu/models/bn.py) takes jnp.mean over the batch,
// which XLA reduces. The port's moments must not depend on how a batch is
// split over data-parallel ranks, and PyTorch's own CUDA reductions pick their
// tree from the tensor's shape, batch size included. Here the order of the
// sums of one (image, channel) is fixed in this source and depends only on
// (C, H, W, dtype, layout), never on N, the grid or the SM count: the caller
// adds the images' rows in global image order afterwards (models/bn.py).
//
// What bounds it on this card: bytes. Each element is read once (2, 4 or 8
// bytes); the output is 16 bytes a channel an image.
//
// Design, two passes:
//   1. H*W is cut into K chunks, K chosen from (C, H*W, layout, dtype) alone.
//      A block sums one chunk of one image (channels_last: a tile of channels;
//      NCHW: one channel) and writes its float64 partials to a staging buffer
//      (straight to `out` when K == 1). Loads are 16 bytes wide and coalesced:
//      in channels_last threads run along C, in NCHW along H*W.
//      channels_last: thread (r, v) of a block adds the pixels r, r + R, ...
//      of the chunk for its vector v of channels, then a shared-memory tree
//      over the R rows. NCHW: a thread adds its vectors in order, then warp
//      shuffles and a tree over the warps. No atomics.
//   2. (K > 1) one thread an output adds the K chunk partials in chunk order.
// The vector width is 16 bytes whenever the shape allows it (C a multiple of
// the elements in 16 bytes for channels_last, H*W for NCHW), and x must then
// be 16-byte aligned: a batch and any slice of it at an image boundary are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long NHWC_CHUNK_ELEMS = 65536;  // elements of one image a block sums in channels_last
constexpr long long NCHW_CHUNK_ELEMS = 8192;   // elements of one plane a block sums in NCHW

// bfloat16 and float32 square in float32, float64 in float64
template <typename T> struct MathOf { using type = float; };
template <> struct MathOf<double> { using type = double; };

__device__ __forceinline__ float to_math(float v) { return v; }
__device__ __forceinline__ float to_math(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_math(double v) { return v; }

__device__ __forceinline__ double square(float v) { return static_cast<double>(__fmul_rn(v, v)); }
__device__ __forceinline__ double square(double v) { return __dmul_rn(v, v); }

// the two bfloat16 of a word as float32 (exact: a bfloat16 is a float32's upper half)
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// V consecutive elements at p (16-byte aligned when V > 1) in the math dtype
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, typename MathOf<T>::type (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_math(p[0]);
  } else {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 2) {
      v[0] = bf_lo(r.x); v[1] = bf_hi(r.x); v[2] = bf_lo(r.y); v[3] = bf_hi(r.y);
      v[4] = bf_lo(r.z); v[5] = bf_hi(r.z); v[6] = bf_lo(r.w); v[7] = bf_hi(r.w);
    } else if constexpr (sizeof(T) == 4) {
      v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
      v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
    } else {
      v[0] = __hiloint2double(static_cast<int>(r.y), static_cast<int>(r.x));
      v[1] = __hiloint2double(static_cast<int>(r.w), static_cast<int>(r.z));
    }
  }
}

// channels_last: block (k * CT + ct, n) sums pixels [k * L, min((k + 1) * L, HW))
// of image n for the channel vectors [ct * TC, (ct + 1) * TC); thread t is
// row t / TC, vector ct * TC + t % TC; R = THREADS / TC rows.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) nhwc_partials(const T* __restrict__ x, double* __restrict__ stage, int C,
                                                         long long HW, int K, long long L, int TC, int CT) {
  __shared__ double sh[2 * V][THREADS];
  const int R = THREADS / TC;
  const int n = blockIdx.y, k = blockIdx.x / CT, ct = blockIdx.x % CT;
  const int t = threadIdx.x, r = t / TC;
  const int cv = ct * TC + t % TC;
  const bool active = r < R && cv * V < C;
  double s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.0;
  if (active) {
    const long long p1 = min((k + 1) * L, HW);
    const T* base = x + static_cast<long long>(n) * HW * C + static_cast<long long>(cv) * V;
    for (long long p = k * L + r; p < p1; p += R) {
      typename MathOf<T>::type v[V];
      load<T, V>(base + p * C, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] += static_cast<double>(v[j]);
        q[j] += square(v[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh[2 * j][t] = s[j];
    sh[2 * j + 1][t] = q[j];
  }
  __syncthreads();
  int span = 1;
  while (span < R) span <<= 1;
  for (int h = span >> 1; h > 0; h >>= 1) {  // row r += row r + h, a fixed tree over the R rows
    if (active && r < h && r + h < R) {
#pragma unroll
      for (int j = 0; j < 2 * V; ++j) sh[j][t] += sh[j][t + h * TC];
    }
    __syncthreads();
  }
  if (active && r == 0) {
    double* row = stage + (static_cast<long long>(n) * K + k) * 2 * C + static_cast<long long>(cv) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      row[j] = sh[2 * j][t];
      row[C + j] = sh[2 * j + 1][t];
    }
  }
}

// NCHW: block (k, c, n) sums elements [k * L, min((k + 1) * L, HW)) of plane
// (n, c), L a multiple of V; thread t adds the vectors t, t + THREADS, ...
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) nchw_partials(const T* __restrict__ x, double* __restrict__ stage, int C,
                                                         long long HW, int K, long long L) {
  __shared__ double sh[2][THREADS / 32];
  const int k = blockIdx.x, c = blockIdx.y, n = blockIdx.z, t = threadIdx.x;
  const T* plane = x + (static_cast<long long>(n) * C + c) * HW;
  const long long p1 = min((k + 1) * L, HW);
  double s = 0.0, q = 0.0;
  for (long long p = k * L + static_cast<long long>(t) * V; p < p1; p += static_cast<long long>(THREADS) * V) {
    typename MathOf<T>::type v[V];
    load<T, V>(plane + p, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s += static_cast<double>(v[j]);
      q += square(v[j]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xFFFFFFFFu, s, off);
    q += __shfl_down_sync(0xFFFFFFFFu, q, off);
  }
  if (t % 32 == 0) {
    sh[0][t / 32] = s;
    sh[1][t / 32] = q;
  }
  __syncthreads();
  if (t < 32) {
    s = t < THREADS / 32 ? sh[0][t] : 0.0;
    q = t < THREADS / 32 ? sh[1][t] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xFFFFFFFFu, s, off);
      q += __shfl_down_sync(0xFFFFFFFFu, q, off);
    }
    if (t == 0) {
      double* row = stage + (static_cast<long long>(n) * K + k) * 2 * C + c;
      row[0] = s;
      row[C] = q;
    }
  }
}

// out[n, j, c] = sum over k in order of stage[n, k, j, c]
__global__ void __launch_bounds__(THREADS) combine_chunks(const double* __restrict__ stage, double* __restrict__ out,
                                                          long long N, int C, int K) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N * 2 * C) return;
  const long long n = i / (2 * C), jc = i % (2 * C);
  const double* src = stage + n * K * 2 * C + jc;
  double acc = src[0];
  for (int k = 1; k < K; ++k) acc += src[static_cast<long long>(k) * 2 * C];
  out[i] = acc;
}

int elems_in_16_bytes(int dtype) { return dtype == 1 ? 8 : dtype == 0 ? 4 : 2; }

// the vector width for this shape: 16 bytes when C (channels_last) or H*W
// (NCHW) is a multiple of it, else one element
int vector_width(int layout, int dtype, long long C, long long HW) {
  const int v = elems_in_16_bytes(dtype);
  return (layout == 1 ? C : HW) % v == 0 ? v : 1;
}

// the chunk length in pixels (channels_last) or elements (NCHW); K = ceil(HW / L)
long long chunk_length(int layout, int dtype, long long C, long long HW) {
  long long k = layout == 1 ? (HW * C + NHWC_CHUNK_ELEMS - 1) / NHWC_CHUNK_ELEMS
                            : (HW + NCHW_CHUNK_ELEMS - 1) / NCHW_CHUNK_ELEMS;
  if (k < 1) k = 1;
  if (k > HW) k = HW;
  long long len = (HW + k - 1) / k;
  const int v = vector_width(layout, dtype, C, HW);
  if (layout == 0) len = (len + v - 1) / v * v;
  return len;
}

template <typename T, int V>
void launch_pass1(int layout, const void* x, double* stage, long long N, int C, long long HW, int K, long long L,
                  cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (layout == 1) {
    const int cvs = (C + V - 1) / V;
    const int tc = cvs < THREADS ? cvs : THREADS;
    const int ct = (cvs + tc - 1) / tc;
    nhwc_partials<T, V><<<dim3(static_cast<unsigned>(K) * ct, static_cast<unsigned>(N)), THREADS, 0, stream>>>(
        xt, stage, C, HW, K, L, tc, ct);
  } else {
    nchw_partials<T, V><<<dim3(K, C, static_cast<unsigned>(N)), THREADS, 0, stream>>>(xt, stage, C, HW, K, L);
  }
}

template <typename T, int VEC>
void launch_pass1_any(int layout, int v, const void* x, double* stage, long long N, int C, long long HW, int K,
                      long long L, cudaStream_t stream) {
  if (v == VEC) {
    launch_pass1<T, VEC>(layout, x, stage, N, C, HW, K, L, stream);
  } else {
    launch_pass1<T, 1>(layout, x, stage, N, C, HW, K, L, stream);
  }
}

}  // namespace

// The number of chunks K of one image's H*W, from the shape, layout (0 NCHW,
// 1 channels_last) and dtype (0 float32, 1 bfloat16, 2 float64) alone; the
// caller gives bn_moments_forward a staging buffer of N * K * 2 * C doubles
// when K > 1. Returns -1 for arguments the kernel does not take.
extern "C" long long bn_moments_chunks(int layout, int dtype, long long C, long long HW) {
  if ((layout != 0 && layout != 1) || dtype < 0 || dtype > 2 || C < 1 || HW < 1) return -1;
  const long long len = chunk_length(layout, dtype, C, HW);
  return (HW + len - 1) / len;
}

// x: (N, C, H, W) NCHW-contiguous (layout 0) or channels_last-contiguous
// (layout 1), float32 (dtype 0), bfloat16 (1) or float64 (2); stage: N * K *
// 2 * C doubles when K = bn_moments_chunks(...) > 1 (ignored when K == 1);
// out: N * 2 * C doubles. Launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError() after the launches (0 when
// they were accepted), cudaErrorMisalignedAddress for an x that is not
// 16-byte aligned where the shape takes 16-byte loads, or an error code for
// arguments it does not take.
extern "C" int bn_moments_forward(const void* x, double* stage, double* out, long long N, long long C, long long HW,
                                  int layout, int dtype, cudaStream_t stream) {
  const long long K = bn_moments_chunks(layout, dtype, C, HW);
  if (K < 1 || N < 1 || N > 65535 || C > 65535 || x == nullptr || out == nullptr || (K > 1 && stage == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int v = vector_width(layout, dtype, C, HW);
  if (v > 1 && reinterpret_cast<uintptr_t>(x) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long L = chunk_length(layout, dtype, C, HW);
  double* dst = K > 1 ? stage : out;
  const int c = static_cast<int>(C), k = static_cast<int>(K);
  if (dtype == 1) {
    launch_pass1_any<__nv_bfloat16, 8>(layout, v, x, dst, N, c, HW, k, L, stream);
  } else if (dtype == 0) {
    launch_pass1_any<float, 4>(layout, v, x, dst, N, c, HW, k, L, stream);
  } else {
    launch_pass1_any<double, 2>(layout, v, x, dst, N, c, HW, k, L, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || K == 1) return static_cast<int>(err);
  const long long outputs = N * 2 * C;
  combine_chunks<<<static_cast<unsigned>((outputs + THREADS - 1) / THREADS), THREADS, 0, stream>>>(stage, out, N, c,
                                                                                                    k);
  return static_cast<int>(cudaGetLastError());
}
