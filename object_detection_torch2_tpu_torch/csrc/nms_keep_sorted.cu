// Exact greedy class-agnostic NMS keep mask over score-sorted boxes, for Hopper.
//
// Replaces the TPU kernel object_detection_torch2_tpu/ops/nms_pallas.py::_nms_kernel
// (reached from ops/nms.py's dense sweep). It computes what that kernel and the
// plain sweep ops/nms.py::_blocked_keep_sorted of this package compute: keep[i]
// is true when candidate i is valid and no KEPT candidate j < i overlaps it at
// IoU > thresh, candidates being in descending score order.
//
// What bounds it on this card: not bytes (inputs are ~5 MB at 32 x 8732) but
// the IoU tests, and the serial dependence of the greedy. At the serving
// path's inputs the greedy needs ~681 M tests, ~0.14 ms at 67 TFLOP/s; a
// kernel that runs the greedy itself can use only one block per image (32 of
// 132 SMs at batch 32) and takes a barrier per kept candidate.
//
// Design: the tests are taken out of the serial part.
// 1. Mask kernel over the 64 x 64 tiles (row block rb, column block cb >= rb),
//    32 x 137 x 138 / 2 = 302,496 tiles at 32 x 8732. Row block r is paired
//    with row block nb-1-r, which together have nb+1 column blocks, and a
//    block of 64 threads walks a run of one pair's tiles; the runs are cut so
//    that there are about eight waves of blocks (35,328 at 32 x 8732): every
//    SM is busy, and the last wave, partly filled, is a small share. For each
//    tile the block stages its 64 column boxes' corners in shared memory;
//    thread t holds row i = rb*64 + t and writes one 64-bit word: bit c of
//    word (i, cb) is overlaps(box_i, box_j) && i < j,
//    j = cb*64 + c, the earlier candidate first as in the plain sweep's
//    pairwise_iou(blk, later). A row block whose rows are all invalid writes
//    nothing (the resolve never reads a row that is not kept) and is left at
//    once; a tile whose columns are all invalid writes zero words without
//    testing.
// 2. Resolve kernel, one block per image (1024 threads; 256 for p <= 2048),
//    walks the column blocks in order. Warp 0 runs the exact greedy of block cb on the
//    diagonal words with bit operations (64 steps, no barriers): a candidate
//    still alive when its turn comes is kept and clears its word's bits.
//    Then all threads OR the kept rows' words for the later column blocks
//    into the `removed` bitset in shared memory. The next block's diagonal
//    words are loaded before that OR pass, so their latency hides behind it.
//    The walk ends once no valid candidate after the block is still alive
//    (exact: only kept candidates suppress).
// The IoU is the center-form arithmetic of core/boxes.py::pairwise_iou,
// operation for operation (min/max that propagate NaN, w*h areas, IEEE
// division). Built with -fmad=false and without --use_fast_math, so nvcc
// contracts no product into an FMA and the mask equals the plain sweep's bit
// for bit. The mask scratch, n * p * ceil(p/64) words, is the wrapper's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;

// min and max that return NaN when either operand is NaN, as torch.minimum
// and torch.maximum do, in one instruction each. Where they differ from
// (a < b || a != a) ? a : b, only the sign of a zero differs, and no zero's
// sign reaches the test below: a difference of two values that is zero is
// clamped to +0, and a zero product fails `iou > thresh` as +0 would.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

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

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                unsigned long long* __restrict__ mask, int p, int nb, int per_block, float thresh) {
  __shared__ float4 col_box[kTile];  // x1, y1, x2, y2 of the tile's columns
  __shared__ float col_area[kTile];

  const int t = threadIdx.x;
  const int r = blockIdx.y;  // row block r, then its partner nb-1-r
  const size_t img = blockIdx.z;
  const float4* b = boxes + img * p;
  const uint8_t* v = valid + img * p;
  const int x_end = min(nb + 1, static_cast<int>(blockIdx.x + 1) * per_block);
  for (int x = blockIdx.x * per_block; x < x_end; ++x) {
    // x -> tile (rb, cb), cb >= rb
    int rb = r, cb = r + x;
    if (x >= nb - r) {
      rb = nb - 1 - r;
      if (rb <= r) break;  // the middle row block of an odd nb is covered once, above
      cb = rb + (x - (nb - r));
    }
    const int i = rb * kTile + t;
    const int j = cb * kTile + t;
    const bool row_valid = i < p && v[i];
    const bool col_valid = j < p && v[j];
    const Corners cj = corners(j < p ? b[j] : make_float4(0.f, 0.f, 0.f, 0.f));
    __syncthreads();  // the previous tile's columns are no longer read
    col_box[t] = make_float4(cj.x1, cj.y1, cj.x2, cj.y2);
    col_area[t] = cj.area;
    if (!__syncthreads_or(row_valid)) {
      // no row of rb is read by the resolve: go on to the partner row block
      if (x >= nb - r) break;
      x = nb - r - 1;
      continue;
    }
    const bool any_col = __syncthreads_or(col_valid);
    if (row_valid) {
      const Corners mine = corners(b[i]);
      unsigned long long word = 0;
      if (any_col) {
        // every column is tested, 8 at a time into a byte (constant shifts);
        // the bits that do not count are cleared after
#pragma unroll 1
        for (int k = 0; k < kTile; k += 8) {
          unsigned int byte = 0;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float4 q = col_box[k + c];
            const Corners s = {q.x, q.y, q.z, q.w, col_area[k + c]};
            byte |= static_cast<unsigned int>(overlaps(mine, s, thresh)) << c;
          }
          word |= static_cast<unsigned long long>(byte) << k;
        }
        // only columns before p count, and on the diagonal tile only those after row i
        const int width = min(kTile, p - cb * kTile);
        if (width < kTile) word &= (1ull << width) - 1;
        if (cb == rb) word &= t + 1 < kTile ? ~0ull << (t + 1) : 0ull;
      }
      mask[(img * p + i) * nb + cb] = word;
    }
  }
}

// kResolveThreads: 1024 for a long walk (more loads in flight in the OR
// pass), 256 for a short one (a smaller block starts and syncs sooner)
template <int kResolveThreads>
__global__ void __launch_bounds__(kResolveThreads)
nms_resolve_kernel(const uint8_t* __restrict__ valid, const unsigned long long* __restrict__ mask,
                   uint8_t* __restrict__ keep_out, int p, int nb) {
  extern __shared__ unsigned long long sh[];
  unsigned long long* removed = sh;     // (nb,) candidates suppressed so far
  unsigned long long* validw = sh + nb;  // (nb,) valid bits
  unsigned long long* keepw = sh + 2 * nb;  // (nb,) kept bits
  __shared__ unsigned long long diag[kTile];  // the current block's diagonal words
  __shared__ int kept_rows[kTile];
  __shared__ int n_kept;
  constexpr int kRowGroups = kResolveThreads / kTile;  // kept rows split over groups of 64 threads

  const int t = threadIdx.x;
  const int lane = t & 31;
  const size_t img = blockIdx.x;
  const uint8_t* v = valid + img * p;
  const unsigned long long* m = mask + img * p * static_cast<size_t>(nb);

  // the valid bits, a word per warp step (the loop is uniform in each warp)
  int any = 0;
  for (int w = t / 32; w < nb; w += kResolveThreads / 32) {
    const int q = w * kTile + lane;
    const unsigned int lo = __ballot_sync(0xffffffffu, q < p && v[q]);
    const unsigned int hi = __ballot_sync(0xffffffffu, q + 32 < p && v[q + 32]);
    if (lane == 0) {
      validw[w] = lo | static_cast<unsigned long long>(hi) << 32;
      removed[w] = 0;
      keepw[w] = 0;
    }
    any |= (lo | hi) != 0;
  }
  // the first block's diagonal words (rows that are not valid are never read)
  if (t < kTile && t < p && v[t]) diag[t] = m[static_cast<size_t>(t) * nb];
  if (!__syncthreads_or(any)) {
    for (int q = t; q < p; q += kResolveThreads) keep_out[img * p + q] = 0;
    return;
  }

  for (int cb = 0; cb < nb; ++cb) {
    // the greedy of block cb, in warp 0, every lane the same
    if (t < 32) {
      const unsigned long long d_lo = diag[lane];
      const unsigned long long d_hi = diag[32 + lane];
      unsigned long long alive = validw[cb] & ~removed[cb];
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        const unsigned long long d = __shfl_sync(0xffffffffu, d_lo, s);
        if ((alive >> s) & 1ull) alive &= ~d;
      }
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        const unsigned long long d = __shfl_sync(0xffffffffu, d_hi, s);
        if ((alive >> (32 + s)) & 1ull) alive &= ~d;
      }
      // alive is now the kept set of the block; list its rows in order
      if (lane == 0) keepw[cb] = alive;
      const unsigned int lo = static_cast<unsigned int>(alive), hi = static_cast<unsigned int>(alive >> 32);
      const unsigned int below = (1u << lane) - 1u;
      if ((lo >> lane) & 1u) kept_rows[__popc(lo & below)] = cb * kTile + lane;
      if ((hi >> lane) & 1u) kept_rows[__popc(lo) + __popc(hi & below)] = cb * kTile + 32 + lane;
      if (lane == 0) n_kept = __popc(lo) + __popc(hi);
    }
    __syncthreads();
    if (cb + 1 == nb) break;

    // the next block's diagonal words, loaded now and stored after the OR pass
    unsigned long long next_diag = 0;
    const int nrow = (cb + 1) * kTile + t;
    if (t < kTile && nrow < p && v[nrow]) next_diag = m[static_cast<size_t>(nrow) * nb + cb + 1];

    // OR the kept rows' words into `removed`: thread t takes column block
    // cb + 1 + t % 64 (and every 64th after it) and every kRowGroups-th kept row
    const int k = n_kept;
    const int grp = t / kTile;
    for (int w = cb + 1 + t % kTile; w < nb; w += kTile) {
      unsigned long long acc = 0;
#pragma unroll 4
      for (int e = grp; e < k; e += kRowGroups) acc |= m[static_cast<size_t>(kept_rows[e]) * nb + w];
      if (acc) atomicOr(&removed[w], acc);
    }
    __syncthreads();
    if (t < kTile) diag[t] = next_diag;
    // anything left alive after this block?
    int alive = 0;
    for (int w = cb + 1 + t; w < nb; w += kResolveThreads) alive |= (validw[w] & ~removed[w]) != 0;
    if (!__syncthreads_or(alive)) break;
  }
  __syncthreads();
  for (int q = t; q < p; q += kResolveThreads) keep_out[img * p + q] = (keepw[q / kTile] >> (q % kTile)) & 1ull;
}

template <int kThreads>
int launch_resolve(const uint8_t* valid, const unsigned long long* mask, uint8_t* keep, int n, int p, int nb,
                   size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(nms_resolve_kernel<kThreads>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_resolve_kernel<kThreads><<<n, kThreads, smem, stream>>>(valid, mask, keep, p, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes (n, p, 4) f32 center-form, score-descending; valid (n, p) 0/1 bytes;
// mask: scratch of n * p * ceil(p / 64) 64-bit words; keep (n, p) 0/1 bytes
// out. Launches both kernels on `stream`, does not synchronise, and returns
// the first CUDA error of the setup or the launches (0 on success).
extern "C" int nms_keep_sorted(const float* boxes, const uint8_t* valid, void* mask, uint8_t* keep, int n,
                               int p, float thresh, cudaStream_t stream) {
  if (n <= 0 || p <= 0) return 0;
  const int nb = (p + kTile - 1) / kTile;
  if (n > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  // each block walks `per_block` tiles of one row-block pair; the runs are cut
  // for about 8 waves of 32 blocks on each of 132 SMs, so that the last,
  // partly filled wave costs little
  const int pairs = (nb + 1) / 2;
  const long long want = (8LL * 132 * 32 + static_cast<long long>(n) * pairs - 1) / (static_cast<long long>(n) * pairs);
  const int split = static_cast<int>(want < nb + 1 ? want : nb + 1);
  const int per_block = (nb + 1 + split - 1) / split;
  const dim3 grid((nb + 1 + per_block - 1) / per_block, pairs, n);
  nms_mask_kernel<<<grid, kTile, 0, stream>>>(reinterpret_cast<const float4*>(boxes), valid,
                                              static_cast<unsigned long long*>(mask), p, nb, per_block, thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 3 * static_cast<size_t>(nb) * sizeof(unsigned long long);
  const auto* words = static_cast<const unsigned long long*>(mask);
  return nb <= 32 ? launch_resolve<256>(valid, words, keep, n, p, nb, smem, stream)
                  : launch_resolve<1024>(valid, words, keep, n, p, nb, smem, stream);
}
