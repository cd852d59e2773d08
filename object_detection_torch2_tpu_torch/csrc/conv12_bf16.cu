// conv_1_2 forward in bfloat16 on Hopper's tensor cores: 3x3, stride 1, zero
// pad 1, 64 -> 64 channels, plus a float32 bias.
//
// Replaces, for bfloat16 input, the TPU kernel
// object_detection_torch2_tpu/ops/conv12_pallas.py::_kernel (reached through
// _conv12_pallas and conv12_paired); csrc/conv12.cu keeps float32. It computes
// what ops/conv12.py::conv12_plain computes, on channels_last (NHWC in memory)
// bfloat16 tensors:
//
//   y[n, co, h, w] = bf16(b[co] + sum_{ky,kx,ci} x[n, ci, h+ky-1, w+kx-1] * w[co, ci, ky, kx])
//
// The bf16 x bf16 products are exact in float32, the tensor cores sum them in
// float32, the float32 bias is added in float32, and the store rounds once.
//
// What bounds it on this card, at the training path's shape (N 32, 300 x 300):
// 2*N*H*W*9*64*64 = 212.3 GFLOP, 0.215 ms at the tensor cores' 989 TFLOP/s;
// x read once and y written once, 0.74 GB, 0.220 ms at 3.35 TB/s. Bytes and
// operations are about even, so the kernel has to keep the tensor cores fed
// while it streams x.
//
// Design: an implicit GEMM with M = the 256 pixels of a 16 x 16 output tile,
// N = 64 output channels, K = 9 taps x 64 input channels = 576, in k-steps of 16.
// - Persistent grid: one block of 256 threads per SM walks the (N, 19, 19)
//   tiles of the batch (the last tile row and column are ragged: 300 = 18*16+12).
// - Weights once per block: the wrapper repacks them to bf16 (tap, co, ci),
//   73,728 B, and the block stages them once, so a call moves ~10 MB of
//   weights from L2 instead of re-reading them per tile.
// - Input halo tiles, 18 x 18 pixels x 64 channels = 41,472 B, staged by
//   cp.async in a ring of two stages: the next tile's copy is in flight while
//   the tensor cores work on this one. A copy of a pixel outside the image
//   reads zero bytes and fills 16 zeros (cp.async's src-size), which is the
//   conv's zero padding with no masking on the load side.
// - Each pixel's 64 channels are one 128-B row of shared memory; its eight
//   16-B chunks are stored at chunk ^ (pixel & 7) (the 128-B swizzle), so the
//   eight row addresses of an ldmatrix phase fall in eight distinct bank groups.
//   The weights' (tap, co) rows are swizzled the same way with co & 7.
// - Operand A of tap (ky, kx) is the halo window shifted by ky rows and kx
//   pixels: ldmatrix takes one row address per lane, so a shift is only
//   another address. ldmatrix brings it into registers, and wgmma
//   (m64n64k16, bf16 -> f32, A from registers) reads B, the tap's weights,
//   from shared memory by a 128-B-swizzle descriptor; the weights sit on a
//   1024-B boundary so that the descriptor's swizzle is the layout's. Each
//   of the 2 warpgroups owns 8 output rows as two m64 tiles (64 float32
//   accumulators a thread); two k-steps are in flight, the second's A loads
//   overlapping the first's products.
// - Epilogue: accumulator + float32 bias, one rounding to bf16, written as
//   bf16 pairs; rows and columns past the image are skipped.
// What holds it back: with N = 64 output channels, every 64 x 64 x 16 product
// reads 2 KB of A (ldmatrix) and 2 KB of B (wgmma) from shared memory, so the
// shared-memory bandwidth is about as scarce as the tensor cores. TMA tile
// loads, or making the pixels the wide N operand, are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;                 // channels in and out
constexpr int TH = 16;                // output rows of a tile
constexpr int TW = 16;                // output columns of a tile
constexpr int HH = TH + 2;            // staged rows, with the halo
constexpr int HW = TW + 2;            // staged columns, with the halo
constexpr int ROW_BYTES = C * 2;      // one pixel's channels, bf16
constexpr int THREADS = 256;          // 8 warps, 2 output rows each
constexpr int STAGES = 2;
constexpr int W_BYTES = 9 * C * ROW_BYTES;              // 73,728
constexpr int TILE_BYTES = HH * HW * ROW_BYTES;         // 41,472
constexpr int TILE_CHUNKS = HH * HW * (ROW_BYTES / 16); // 2,592 16-B copies
// + 1024: the weights start on a 1024-B boundary, as the swizzle's 8-row groups must
constexpr size_t SMEM_BYTES = W_BYTES + STAGES * TILE_BYTES + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// 64-bit shared-memory matrix descriptor of a K-major operand stored in
// 128-B rows with the 128-B swizzle (16-B chunk c of row r at chunk c ^ (r & 7),
// rows in 1024-B groups of 8): start address, leading offset 1 (unused with
// this swizzle), stride 1024 B between 8-row groups, layout SWIZZLE_128B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64 f32 over the warpgroup) += A (64 x 16 bf16; this warp's 16 rows
// in registers, as the mma.sync m16k16 fragment) x B (16 x 64, by descriptor).
// The scale-d predicate is set: the product is added to d.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// byte offset of 16-B chunk `chunk` of swizzled row `row`
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * ROW_BYTES + ((chunk ^ (row & 7)) << 4));
}

struct Tiling {
  int H, W, tiles_w, tiles_per_image, tiles;
};

// queue the halo of tile `t` into the stage at shared address `dst`
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ x, uint32_t dst, int t,
                                          const Tiling& g) {
  const int n = t / g.tiles_per_image;
  const int r = t - n * g.tiles_per_image;
  const int h0 = (r / g.tiles_w) * TH - 1;
  const int w0 = (r % g.tiles_w) * TW - 1;
  for (int i = threadIdx.x; i < TILE_CHUNKS; i += THREADS) {
    const int pix = i >> 3;
    const int chunk = i & 7;
    const int gh = h0 + pix / HW;
    const int gw = w0 + pix % HW;
    const bool in = gh >= 0 && gh < g.H && gw >= 0 && gw < g.W;
    const __nv_bfloat16* src = in ? x + ((static_cast<size_t>(n) * g.H + gh) * g.W + gw) * C + chunk * 8 : x;
    cp_async16(dst + swz(pix, chunk), src, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
conv12_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wpk,
                   const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, Tiling g) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_w = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t s_in = s_w + W_BYTES;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // warpgroup wg owns output rows 8*wg .. 8*wg + 7 of the tile as two m64
  // tiles; in m64 tile mt this warp's 16 rows are output row 8*wg + 4*mt + warp % 4
  const int row0 = 8 * (warp >> 2) + (warp & 3);

  // the weights, once: (tap, co) rows of 64 ci, in the first group with tile 0
  for (int i = threadIdx.x; i < 9 * C * 8; i += THREADS) {
    cp_async16(s_w + swz(i >> 3, i & 7), wpk + i * 8, 16);
  }
  int t = blockIdx.x;
  if (t < g.tiles) load_tile(x, s_in, t, g);
  cp_async_commit();

  // the bias of the 16 output channels this thread writes
  float bl[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    bl[nt][0] = bias[nt * 8 + 2 * (lane & 3)];
    bl[nt][1] = bias[nt * 8 + 2 * (lane & 3) + 1];
  }

  // per-lane parts of the A (ldmatrix) addresses
  const int a_pix = lane & 15;          // pixel of the warp's 16 rows
  const int a_half = lane >> 4;         // k half (channels 0-7 or 8-15 of the step)

  for (int it = 0; t < g.tiles; t += gridDim.x, ++it) {
    const int next = t + gridDim.x;
    if (next < g.tiles) load_tile(x, s_in + ((it + 1) % STAGES) * TILE_BYTES, next, g);
    cp_async_commit();
    cp_async_wait_one();  // this tile (and the weights) have landed
    // the weights are read by wgmma, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const uint32_t stage = s_in + (it % STAGES) * TILE_BYTES;
    float acc[2][32];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[mt][q] = 0.0f;
    // A of two k-steps in flight: step s loads a[s % 2] while step s - 1's
    // wgmmas may still read a[(s - 1) % 2]
    uint32_t a[2][2][4];

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - 3 * ky;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {  // 16 input channels a step
        uint32_t (&ak)[2][4] = a[kc & 1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int pix = (row0 + 4 * mt + ky) * HW + a_pix + kx;
          ldmatrix_x4(stage + swz(pix, 2 * kc + a_half), ak[mt][0], ak[mt][1], ak[mt][2], ak[mt][3]);
        }
        // B: the tap's (co, ci) rows; k-step kc is 32 B into each swizzled row
        const uint64_t desc = sw128_desc(s_w + tap * C * ROW_BYTES + kc * 32);
        wgmma_fence();
        wgmma_m64n64k16(acc[0], ak[0], desc);
        wgmma_m64n64k16(acc[1], ak[1], desc);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step is done, and its A registers free
      }
    }
    wgmma_wait<0>();

    // epilogue: rows row0 + 4*mt of the tile; pixels lane/4 and lane/4 + 8;
    // acc[mt][4*nt + q] is the mma.sync fragment of n8 tile nt
    const int n = t / g.tiles_per_image;
    const int r = t - n * g.tiles_per_image;
    const int h0 = (r / g.tiles_w) * TH;
    const int w0 = (r % g.tiles_w) * TW;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int oh = h0 + row0 + 4 * mt;
      if (oh >= g.H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ow = w0 + (lane >> 2) + 8 * half;
        if (ow >= g.W) continue;
        __nv_bfloat16* dst = y + ((static_cast<size_t>(n) * g.H + oh) * g.W + ow) * C + 2 * (lane & 3);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8) = __floats2bfloat162_rn(
              acc[mt][4 * nt + 2 * half] + bl[nt][0], acc[mt][4 * nt + 2 * half + 1] + bl[nt][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is loaded again
  }
}

}  // namespace

// x, y: (n, 64, h, w) channels_last bfloat16; wpk: (3, 3, 64 co, 64 ci)
// bfloat16; bias: (64,) float32. Launches on `stream`, does not synchronise,
// and returns the first CUDA error of the setup or the launch (0 on success).
extern "C" int conv12_bf16_forward(const void* x, const void* wpk, const float* bias, void* y, int n, int h,
                                   int w, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  Tiling g;
  g.H = h;
  g.W = w;
  g.tiles_w = (w + TW - 1) / TW;
  g.tiles_per_image = ((h + TH - 1) / TH) * g.tiles_w;
  const long long tiles = static_cast<long long>(n) * g.tiles_per_image;
  if (tiles > 0x7fffffffLL - 65536) return static_cast<int>(cudaErrorInvalidConfiguration);
  g.tiles = static_cast<int>(tiles);

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv12_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = g.tiles < sms ? g.tiles : sms;
  conv12_bf16_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                                            static_cast<const __nv_bfloat16*>(wpk), bias,
                                                            static_cast<__nv_bfloat16*>(y), g);
  return static_cast<int>(cudaGetLastError());
}
