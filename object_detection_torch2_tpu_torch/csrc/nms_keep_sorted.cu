// Exact greedy class-agnostic NMS keep mask over score-sorted boxes, for Hopper.
//
// Replaces the TPU kernel object_detection_torch2_tpu/ops/nms_pallas.py::_nms_kernel
// (reached from ops/nms.py's dense sweep). It computes what that kernel and the
// plain sweep ops/nms.py::_blocked_keep_sorted of this package compute: keep[i]
// is true when candidate i is valid and no KEPT candidate j < i overlaps it at
// IoU > thresh, candidates being in descending score order.
//
// Design (a simple, correct first kernel):
// - One thread block per image, 128 threads; thread t owns lane t of the
//   current 128-wide block of candidates. The keep mask lives in shared memory
//   (P bytes); the (P, 4) center-form boxes are read from global memory, where
//   a batch of 32 x 8732 boxes (4.5 MB) stays in the 50 MB L2.
// - In each block, an exact sequential greedy over the 128 lanes: for j in
//   order, a kept lane j clears every later lane i of the block that it overlaps.
//   The barrier is taken only after a kept lane (the branch is uniform: every
//   thread reads the same shared byte after the last barrier).
// - The block's kept pivots are then compacted into shared memory, and each
//   thread walks the later candidates q = start + 128 + t, +128, ...; a still
//   alive q is cleared when any pivot overlaps it.
// - Early exit, per image: once no candidate at or after the next block is
//   alive, nothing later can change (only kept candidates suppress).
// - The IoU is the center-form arithmetic of core/boxes.py::pairwise_iou,
//   operation for operation (min/max that propagate NaN, w*h areas, IEEE
//   division). Built with -fmad=false and without --use_fast_math, so nvcc
//   contracts no product into an FMA and the mask equals the plain sweep's bit
//   for bit.
//
// What bounds it on this card: not bytes (inputs are ~5 MB at bs 32 x 8732)
// nor operations (a few GFLOP at most), but the serial dependence of the
// greedy: up to 128 barriers per block of candidates, 69 blocks at P = 8732.
// A grid of N blocks fills only N of the H100's 132 SMs (32 at bs 32); that
// limit is recorded here, not addressed, in this first version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }

// A box as pairwise_iou sees it: its corners and its w*h area.
struct Corners {
  float x1, y1, x2, y2, area;
};

__device__ __forceinline__ Corners corners(float4 b) {
  Corners c;
  c.x1 = b.x - b.z / 2.0f;
  c.y1 = b.y - b.w / 2.0f;
  c.x2 = b.x + b.z / 2.0f;
  c.y2 = b.y + b.w / 2.0f;
  c.area = b.z * b.w;
  return c;
}

// IoU(t, s) > thresh, with pairwise_iou's operation order:
// w = clamp(min(t_x2, s_x2) - max(t_x1, s_x1), 0), inter = w * h,
// union = t_area + s_area - inter, iou = inter > 0 ? inter / union : inter.
__device__ __forceinline__ bool overlaps(const Corners& t, const Corners& s, float thresh) {
  float w = max_nan(min_nan(t.x2, s.x2) - max_nan(t.x1, s.x1), 0.0f);
  float h = max_nan(min_nan(t.y2, s.y2) - max_nan(t.y1, s.y1), 0.0f);
  float inter = w * h;
  float uni = t.area + s.area - inter;
  float iou = inter > 0.0f ? inter / uni : inter;
  return iou > thresh;
}

__global__ void __launch_bounds__(kBlock)
nms_keep_sorted_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                       uint8_t* __restrict__ keep_out, int p, float thresh) {
  extern __shared__ uint8_t keep[];  // (p,)
  __shared__ Corners blk[kBlock];
  __shared__ Corners piv[kBlock];
  __shared__ int npiv;

  const int t = threadIdx.x;
  const size_t img = blockIdx.x;
  const float4* b = boxes + img * p;

  for (int q = t; q < p; q += kBlock) keep[q] = valid[img * p + q];

  for (int start = 0; start < p; start += kBlock) {
    int alive = 0;
    for (int q = start + t; q < p; q += kBlock) alive |= keep[q];
    // also the barrier that ends the previous block's cross pass
    if (!__syncthreads_or(alive)) break;

    const int i = start + t;
    const int width = min(kBlock, p - start);
    const bool in = t < width;
    Corners mine = corners(in ? b[i] : make_float4(0.f, 0.f, 0.f, 0.f));
    blk[t] = mine;
    if (t == 0) npiv = 0;
    __syncthreads();

    // in-block greedy, lane by lane
    for (int j = 0; j < width; ++j) {
      if (keep[start + j]) {
        if (t > j && in && keep[i] && overlaps(blk[j], mine, thresh)) keep[i] = 0;
        __syncthreads();
      }
    }

    if (in && keep[i]) piv[atomicAdd(&npiv, 1)] = mine;
    __syncthreads();

    // kept pivots suppress every later candidate
    const int m = npiv;
    for (int q = start + kBlock + t; q < p; q += kBlock) {
      if (!keep[q]) continue;
      const Corners s = corners(b[q]);
      for (int k = 0; k < m; ++k) {
        if (overlaps(piv[k], s, thresh)) {
          keep[q] = 0;
          break;
        }
      }
    }
  }
  __syncthreads();
  for (int q = t; q < p; q += kBlock) keep_out[img * p + q] = keep[q];
}

}  // namespace

// boxes (n, p, 4) f32 center-form, score-descending; valid (n, p) 0/1 bytes;
// keep (n, p) 0/1 bytes out. Launches on `stream`, does not synchronise, and
// returns the launch's cudaGetLastError() (0 on success).
extern "C" int nms_keep_sorted(const float* boxes, const uint8_t* valid, uint8_t* keep, int n, int p,
                               float thresh, cudaStream_t stream) {
  if (n <= 0 || p <= 0) return 0;
  const size_t smem = static_cast<size_t>(p);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(nms_keep_sorted_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_keep_sorted_kernel<<<n, kBlock, smem, stream>>>(reinterpret_cast<const float4*>(boxes), valid,
                                                      keep, p, thresh);
  return static_cast<int>(cudaGetLastError());
}
