// The int8 convolution of the quantized SSD layers for Hopper: s8 x s8 -> s32
// on the int8 tensor cores through wgmma, with the per-channel dequantization
// and the bias fused into the epilogue.
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
// shapes. Only wgmma reaches that rate. The small late layers (extras, heads
// at 1x1 to 10x10) are bound by neither, but by launch and tile waste.
//
// Design: an implicit GEMM, M = N*Ho*Wo output pixels, Ncol = Cout, K =
// kh*kw*Cin (Cin a multiple of 32, so a 16-byte chunk of K never straddles
// two taps), warp-specialised, persistent and ping-ponged:
// - A tile is 128 pixels x 128 output channels where Cout <= 128, 64 pixels
//   x 256 channels above (128 int32 accumulators a thread either way); K
//   goes in stages of 128 bytes, four wgmma k32 steps a stage. One block of
//   384 threads per SM walks the (M, Cout) tiles, the Cout tiles of one M
//   tile consecutive so that neighbouring blocks share A in L2.
// - Warpgroups 0 and 1 consume, each a whole tile in turn (tiles 0, 2, 4, ...
//   of the block to warpgroup 0, 1, 3, 5, ... to warpgroup 1): one issues
//   wgmma.m64nBNk32.s32.s8.s8 (one or two a k32 step) with both operands read
//   from shared memory by 128-byte-swizzle descriptors (8-bit wgmma takes
//   K-major operands only), while the other runs its epilogue and waits for
//   its next tile's stages, so the tensor cores are not left idle during an
//   epilogue.
// - Warpgroup 2 produces, with its registers cut by setmaxnreg: a ring of
//   stages (6 at BN 128, 5 at BN 256; 192 and 200 KB) guarded by "full" and
//   "empty" mbarriers, filled in tile order. B, the (Cout, K) weight matrix, comes by
//   TMA: a 2-D tensor map with the 128-byte swizzle built on the host for
//   each call, whose out-of-bounds zero fill is the ragged Cout of the heads
//   (100, 150) and the K tail. A, the im2col rows:
//   * where Cin is a multiple of 128 (a stage is 128 channels of one tap), by
//     TMA's im2col mode: a 4-D (C, W, H, N) tensor map whose pixel bounding
//     box is the conv's padding and whose traversal stride is its stride;
//     one load a stage gathers the tile's pixels at the stage's tap
//     offset, zero outside the image and past the batch;
//   * otherwise (Cin 32 or 64: conv_1_2, 2_1) by the 128 producer threads,
//     16-byte cp.async copies into the same swizzled layout (each thread one
//     16-byte chunk of K for 8 or 4 rows), the padding, rows past M and the
//     K tail zero-filled (src-size 0), so a ragged last K stage (Cin 64 gives
//     K 576) sums zeros, not stale bytes; the copies complete on the stage's
//     full barrier (cp.async.mbarrier.arrive.noinc), beside the TMA's bytes.
// - A consumer waits for a stage, fences the generic proxy (cp.async writes)
//   against wgmma's async proxy, issues the stage's wgmmas, and frees
//   the stage before it after wgmma.wait_group 1, so one stage's products
//   overlap the next stage's issue and the producer's copies.
// - Epilogue from the wgmma accumulator layout (thread t of a warpgroup holds
//   rows 16*(t/32) + (t%32)/4 (+8) and column pairs 8j + 2*(t%4)), the scale
//   and bias pairs read as one vector each. Where a row of y is a multiple
//   of 16 bytes (every trunk layer) each warp stages its 16 rows through a
//   shared scratch (20 KB for the block) and writes them back as whole
//   16-byte pieces of rows, bounds-checked against M; the stores straight
//   from the accumulators, half a 32-byte sector each, took more time than
//   the products. Otherwise (the heads' Cout 100 and 150 in bfloat16) the
//   outputs go straight out as one 8- or 4-byte store a pair, bounds-checked
//   against M and Cout.
// Later work (not here): TMA's im2col mode for Cin 32 and 64; TMA stores
// from the scratch; a cluster sharing B by multicast.

#include <cuda.h>  // CUtensorMap and its enums; the encoders are looked up at run time, libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BK = 128;           // bytes of K a stage holds: four wgmma k32 steps
constexpr int CONSUMERS = 256;    // warpgroups 0 and 1
constexpr int THREADS = 384;      // + the producer warpgroup
constexpr int RING_BYTES = 204800;
// the staged epilogue's scratch: a consumer warp's 16 output rows x 128
// bytes, each row padded by 32 bytes against bank conflicts
constexpr int CHUNK_BYTES = 128;
constexpr int STAGE_PITCH = CHUNK_BYTES + 32;
constexpr int SCRATCH_BYTES = 8 * 16 * STAGE_PITCH;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;  // 128 * 56 + 256 * 224 <= 65,536

template <int BN>
struct Cfg {
  // a tile's output pixels: two m64 products a k32 step at BN 128, one at
  // BN 256 (128 int32 accumulators a thread either way)
  static constexpr int BM = BN == 128 ? 128 : 64;
  static constexpr int MT = BM / 64;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // a multiple of 1024: every tile on a swizzle-atom boundary
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;  // 6 at BN 128, 5 at BN 256
  // + 1024: the ring starts on a 1024-B boundary; then the epilogue scratch,
  // the full and empty barriers and the two turns
  static constexpr size_t SMEM =
      1024 + static_cast<size_t>(STAGES) * STAGE_BYTES + SCRATCH_BYTES + (2 * STAGES + 2) * 8;
};

struct Shape {
  int n, h, w, cin, cout, kh, kw, stride, pad, ho, wo;
  int k_total, ktiles, ntiles, tiles;
  int im2col;  // A by TMA's im2col mode (Cin a multiple of 128), else by cp.async
  long long m_total;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- copies
// 16 bytes global -> shared; src_bytes 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
// one arrival on `bar` once every cp.async this thread issued before has landed
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// the (k0, row0) box of the 2-D tensor map into shared memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

// 64 pixels x 128 channels of the im2col matrix: the pixels from (c, w, h, n)
// on along the map's bounding box, each read at (w + off_w, h + off_h)
__device__ __forceinline__ void tma_load_im2col(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c, int w,
                                                int h, int n, uint16_t off_w, uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, "
      "%6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n), "h"(off_w), "h"(off_h)
      : "memory");
}

// ---- wgmma
// descriptor of a K-major operand in 128-B rows with the 128-B swizzle (16-B
// chunk c of row r at chunk c ^ (r & 7), rows in 1024-B groups of 8): start
// address, leading offset 1 (unused with this swizzle), stride 1024 B between
// 8-row groups, layout SWIZZLE_128B
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x BN int32 over the warpgroup) = A (64 x 32 s8) x B (32 x BN s8)^T,
// both by descriptor, + d when scale_d != 0
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}



// ---- the producer warpgroup: B by TMA; A by TMA's im2col mode or gathered by cp.async
template <int BN>
__device__ __forceinline__ void produce(const int8_t* __restrict__ x, const CUtensorMap* wmap,
                                        const CUtensorMap* xmap, uint32_t ring, uint32_t full, uint32_t empty,
                                        const Shape& sh) {
  using C = Cfg<BN>;
  const int p = threadIdx.x - CONSUMERS;
  if (sh.im2col && p != 0) return;  // one thread issues both loads of a stage
  const int chunk = p & 7;  // cp.async: this thread's 16-byte chunk of every staged row's 128 bytes of K
  const int rsub = p >> 3;  // ... of rows rsub + 16 * i, i < BM / 16
  const uint32_t a_off = static_cast<uint32_t>(rsub * BK + ((chunk ^ (rsub & 7)) << 4));
  const long long hw = static_cast<long long>(sh.ho) * sh.wo;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < sh.tiles; t += gridDim.x) {
    const long long m0 = static_cast<long long>(t / sh.ntiles) * C::BM;
    const int n0 = (t % sh.ntiles) * BN;
    // cp.async: each row's image (-1 past M) and its window's top-left (hi0,
    // wi0) packed as 16-bit halves; im2col: the tile's first window
    int rimg[C::BM / 16], rhw[C::BM / 16];
#pragma unroll
    for (int i = 0; i < C::BM / 16; ++i) {
      const long long m = sh.im2col ? m0 : m0 + rsub + 16 * i;
      rimg[i] = -1;
      rhw[i] = 0;
      if (m < sh.m_total && (i == 0 || !sh.im2col)) {
        const long long img = m / hw;
        const int rem = static_cast<int>(m - img * hw);
        const int ho = rem / sh.wo;
        const int hi0 = ho * sh.stride - sh.pad;
        const int wi0 = (rem - ho * sh.wo) * sh.stride - sh.pad;
        rimg[i] = static_cast<int>(img);
        rhw[i] = static_cast<int>((static_cast<uint32_t>(hi0) << 16) | (static_cast<uint32_t>(wi0) & 0xFFFFu));
      }
    }
    // the tap (tr, tc) and channel ci of this thread's chunk in the next stage
    int ci = sh.im2col ? 0 : chunk * 16, tr = 0, tc = 0;
    while (ci >= sh.cin) {
      ci -= sh.cin;
      if (++tc == sh.kw) {
        tc = 0;
        ++tr;
      }
    }
    for (int ks = 0; ks < sh.ktiles; ++ks) {
      const uint32_t full_s = full + 8 * stage, a_s = ring + stage * C::STAGE_BYTES;
      mbar_wait(empty + 8 * stage, phase ^ 1);
      if (sh.im2col) {
        mbar_arrive_expect_tx(full_s, C::A_BYTES + C::B_BYTES);
        tma_load_im2col(a_s, xmap, full_s, ci, static_cast<int>(static_cast<short>(rhw[0] & 0xFFFF)), rhw[0] >> 16,
                        rimg[0], static_cast<uint16_t>(tc), static_cast<uint16_t>(tr));
        tma_load_2d(a_s + C::A_BYTES, wmap, full_s, ks * BK, n0);
      } else {
        if (p == 0) {
          mbar_arrive_expect_tx(full_s, C::B_BYTES);
          tma_load_2d(a_s + C::A_BYTES, wmap, full_s, ks * BK, n0);
        }
        const bool k_ok = ks * BK + chunk * 16 < sh.k_total;
#pragma unroll
        for (int i = 0; i < C::BM / 16; ++i) {
          const int hi = (rhw[i] >> 16) + tr;
          const int wi = static_cast<int>(static_cast<short>(rhw[i] & 0xFFFF)) + tc;
          const bool ok = k_ok && rimg[i] >= 0 && static_cast<unsigned>(hi) < static_cast<unsigned>(sh.h) &&
                          static_cast<unsigned>(wi) < static_cast<unsigned>(sh.w);
          const int8_t* src =
              ok ? x + (static_cast<long long>(rimg[i] * sh.h + hi) * sh.w + wi) * sh.cin + ci : x;
          cp_async16(a_s + a_off + i * 16 * BK, src, ok ? 16 : 0);
        }
        cp_async_arrive_noinc(full_s);
      }
      ci += BK;
      while (ci >= sh.cin) {
        ci -= sh.cin;
        if (++tc == sh.kw) {
          tc = 0;
          ++tr;
        }
      }
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one output pair (or a single value, `two` false): y[off], y[off + 1] of
// accumulators v0, v1 with the scales s0, s1 and the biases b0, b1 (as float)
template <int MODE>
__device__ __forceinline__ void store_pair(void* y, long long off, bool two, int v0, int v1, float s0, float s1,
                                           bool has_bias, float b0, float b1) {
  if (MODE == 0) {
    int* p = static_cast<int*>(y) + off;
    if (two) {
      *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
    } else {
      p[0] = v0;
    }
  } else if (MODE == 1) {
    float r0 = __fmul_rn(__int2float_rn(v0), s0), r1 = __fmul_rn(__int2float_rn(v1), s1);
    if (has_bias) {
      r0 = __fadd_rn(r0, b0);
      r1 = __fadd_rn(r1, b1);
    }
    float* p = static_cast<float*>(y) + off;
    if (two) {
      *reinterpret_cast<float2*>(p) = make_float2(r0, r1);
    } else {
      p[0] = r0;
    }
  } else {
    __nv_bfloat16 r0 = __float2bfloat16_rn(__fmul_rn(__int2float_rn(v0), s0));
    __nv_bfloat16 r1 = __float2bfloat16_rn(__fmul_rn(__int2float_rn(v1), s1));
    if (has_bias) {  // the bias is a bfloat16 here: its float is exact
      r0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r0), b0));
      r1 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r1), b1));
    }
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(y) + off;
    if (two) {
      __nv_bfloat162 pr;
      pr.x = r0;
      pr.y = r1;
      *reinterpret_cast<__nv_bfloat162*>(p) = pr;
    } else {
      p[0] = r0;
    }
  }
}

// ---- the consumer warpgroups: every other tile each, wgmma over the ring, then the epilogue

// The staged epilogue of one m64 product: the warp's 16 rows go through its
// scratch in 128-byte column chunks, written in the accumulator layout and
// read back 16 bytes a lane along the rows, so that each global store is a
// whole 16-byte piece of a row and a warp instruction writes four 128-byte
// runs. Taken where a row of y is a multiple of 16 bytes. The row pitch keeps
// both phases free of bank conflicts: 36 words (bfloat16 pairs, one word a
// lane: 4g + t spans the 32 banks) or 40 (int32 / float32 pairs, two words
// a lane: 8g + 2t spans them in each half-warp).
template <int BN, int MODE>
__device__ __forceinline__ void epilogue_staged(const int (&acc)[BN / 2], long long row0, int n0, uint32_t scratch,
                                                const float* __restrict__ scale, const void* __restrict__ bias,
                                                void* __restrict__ y, const Shape& sh) {
  constexpr int ES = MODE == 2 ? 2 : 4;                     // bytes of an output
  constexpr int PITCH = MODE == 2 ? STAGE_PITCH - 16 : STAGE_PITCH;
  constexpr int CHUNK = CHUNK_BYTES / ES;                   // columns of a chunk
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c0 = 0; c0 < BN; c0 += CHUNK) {
    if (n0 + c0 >= sh.cout) break;
    __syncwarp();  // the previous chunk's reads are done
#pragma unroll
    for (int jj = 0; jj < CHUNK / 8; ++jj) {
      const int j = c0 / 8 + jj;
      const int co = n0 + 8 * j + 2 * t;
      float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (MODE != 0 && co < sh.cout) {
        const float2 sv = *reinterpret_cast<const float2*>(scale + co);
        s0 = sv.x;
        s1 = sv.y;
        if (bias != nullptr) {
          if (MODE == 1) {
            const float2 bv = *reinterpret_cast<const float2*>(static_cast<const float*>(bias) + co);
            b0 = bv.x;
            b1 = bv.y;
          } else {
            const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(
                static_cast<const __nv_bfloat16*>(bias) + co);
            b0 = __bfloat162float(bv.x);
            b1 = __bfloat162float(bv.y);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const uint32_t dst = scratch + (g + 8 * h) * PITCH + (8 * jj + 2 * t) * ES;
        if (MODE == 0) {
          asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(dst), "r"(v0), "r"(v1) : "memory");
        } else if (MODE == 1) {
          float r0 = __fmul_rn(__int2float_rn(v0), s0), r1 = __fmul_rn(__int2float_rn(v1), s1);
          if (bias != nullptr) {
            r0 = __fadd_rn(r0, b0);
            r1 = __fadd_rn(r1, b1);
          }
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(dst), "f"(r0), "f"(r1) : "memory");
        } else {
          __nv_bfloat16 r0 = __float2bfloat16_rn(__fmul_rn(__int2float_rn(v0), s0));
          __nv_bfloat16 r1 = __float2bfloat16_rn(__fmul_rn(__int2float_rn(v1), s1));
          if (bias != nullptr) {  // the bias is a bfloat16 here: its float is exact
            r0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r0), b0));
            r1 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r1), b1));
          }
          const uint32_t pr = static_cast<uint32_t>(__bfloat16_as_ushort(r0)) |
                              (static_cast<uint32_t>(__bfloat16_as_ushort(r1)) << 16);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(pr) : "memory");
        }
      }
    }
    __syncwarp();  // the chunk is in the scratch
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int r = 4 * step + (lane >> 3);
      const int cb = (lane & 7) * 16;  // byte of the chunk's row
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(scratch + r * PITCH + cb)
                   : "memory");
      const long long mo = row0 + r;
      const int col = n0 + c0 + cb / ES;
      if (mo < sh.m_total && col < sh.cout)
        *reinterpret_cast<uint4*>(static_cast<char*>(y) + (mo * sh.cout + col) * ES) = v;
    }
  }
}

// The turn: a warpgroup waits on full barriers only after the other one has
// seen its own tile's last stage arrive. A parity wait tells only even from
// odd phases, so a warpgroup that waited for a stage two uses of its slot
// ahead would pass at once; in turns, every stage before the tile's first
// has completed, and each slot is at most at the phase of the stage awaited.
// It also staggers the two: one issues its products while the other runs its
// epilogue.
template <int BN, int MODE>
__device__ __forceinline__ void consume(const float* __restrict__ scale, const void* __restrict__ bias,
                                        void* __restrict__ y, uint32_t ring, uint32_t full, uint32_t empty,
                                        uint32_t turn, uint32_t scratch, const Shape& sh) {
  using C = Cfg<BN>;
  const int cw = threadIdx.x >> 7;          // this warpgroup takes the block's tiles i with i % 2 == cw
  const int warp = (threadIdx.x >> 5) & 3;  // ... its warp 16 rows of each m64 product
  const int lane = threadIdx.x & 31;
  const bool pairs = (sh.cout & 1) == 0;    // every pair access aligned
  const bool staged = sh.cout * (MODE == 2 ? 2 : 4) % 16 == 0;  // rows of y in whole 16-byte pieces
  scratch += (threadIdx.x >> 5) * 16 * STAGE_PITCH;              // this warp's
  int pos = 0;                              // the ring position of the block's next tile's first stage
  int acc[C::MT][BN / 2];
  for (int t = blockIdx.x, i = 0; t < sh.tiles; t += gridDim.x, ++i, pos += sh.ktiles) {
    if ((i & 1) != cw) continue;
    // the other warpgroup's (i-1)-th tile has all its stages: the (i-1)/2-th turn handed to this one
    if (i > 0) mbar_wait(turn + 8 * cw, ((i - 1) >> 1) & 1);
    const long long m0 = static_cast<long long>(t / sh.ntiles) * C::BM;
    const int n0 = (t % sh.ntiles) * BN;
    int stage = pos % C::STAGES;
    uint32_t phase = (pos / C::STAGES) & 1;
    int prev = 0;
    for (int ks = 0; ks < sh.ktiles; ++ks) {
      mbar_wait(full + 8 * stage, phase);
      if (ks == sh.ktiles - 1 && lane == 0) mbar_arrive(turn + 8 * (cw ^ 1));  // hand over the turn
      // the cp.async bytes of A were written through the generic proxy; wgmma reads through the async one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t a = ring + stage * C::STAGE_BYTES;
      const uint32_t b = a + C::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          wgmma_s8<BN>(acc[mt], sw128_desc(a + mt * 64 * BK + 32 * kk), sw128_desc(b + 32 * kk), (ks | kk) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free its slot
      if (ks > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    if (staged) {
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
        epilogue_staged<BN, MODE>(acc[mt], m0 + 64 * mt + 16 * warp, n0, scratch, scale, bias, y, sh);
      continue;
    }

    // epilogue: acc[mt][4j + 2h + e] is pixel m0 + 64mt + 16warp + lane/4 + 8h,
    // channel n0 + 8j + 2(lane%4) + e
    const long long mrow = m0 + 16 * warp + (lane >> 2);
    const int col = n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = col + 8 * j;
      if (co >= sh.cout) continue;
      const bool two = co + 1 < sh.cout;
      const bool vec = two && pairs;
      float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (MODE != 0) {
        if (vec) {
          const float2 sv = *reinterpret_cast<const float2*>(scale + co);
          s0 = sv.x;
          s1 = sv.y;
        } else {
          s0 = scale[co];
          s1 = two ? scale[co + 1] : 0.f;
        }
        if (bias != nullptr) {
          if (MODE == 1) {
            const float* bp = static_cast<const float*>(bias) + co;
            if (vec) {
              const float2 bv = *reinterpret_cast<const float2*>(bp);
              b0 = bv.x;
              b1 = bv.y;
            } else {
              b0 = bp[0];
              b1 = two ? bp[1] : 0.f;
            }
          } else {
            const __nv_bfloat16* bp = static_cast<const __nv_bfloat16*>(bias) + co;
            if (vec) {
              const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(bp);
              b0 = __bfloat162float(bv.x);
              b1 = __bfloat162float(bv.y);
            } else {
              b0 = __bfloat162float(bp[0]);
              b1 = two ? __bfloat162float(bp[1]) : 0.f;
            }
          }
        }
      }
#pragma unroll
      for (int mh = 0; mh < 2 * C::MT; ++mh) {
        const int mt = mh >> 1, h = mh & 1;
        const long long mo = mrow + 64 * mt + 8 * h;
        if (mo >= sh.m_total) continue;
        const long long off = mo * sh.cout + co;
        const int v0 = acc[mt][4 * j + 2 * h], v1 = acc[mt][4 * j + 2 * h + 1];
        if (vec) {
          store_pair<MODE>(y, off, true, v0, v1, s0, s1, bias != nullptr, b0, b1);
        } else {
          store_pair<MODE>(y, off, false, v0, 0, s0, 0.f, bias != nullptr, b0, 0.f);
          if (two) store_pair<MODE>(y, off + 1, false, v1, 0, s1, 0.f, bias != nullptr, b1, 0.f);
        }
      }
    }
  }
}

template <int BN, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
int8_conv_kernel(const int8_t* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap, const float* __restrict__ scale,
                 const void* __restrict__ bias, void* __restrict__ y, Shape sh) {
  using C = Cfg<BN>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t ring = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t scratch = ring + C::STAGES * C::STAGE_BYTES;
  const uint32_t full = scratch + SCRATCH_BYTES;  // STAGES barriers of 8 bytes
  const uint32_t empty = full + 8 * C::STAGES;
  const uint32_t turn = empty + 8 * C::STAGES;  // the turn of warpgroup 0, then of 1
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      // im2col: the one expect_tx arrival; cp.async: + each producer thread's copies' arrival
      mbar_init(full + 8 * s, sh.im2col ? 1 : 128 + 1);
      mbar_init(empty + 8 * s, 4);  // one arrival per warp of the consuming warpgroup
    }
    mbar_init(turn, 4);
    mbar_init(turn + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    produce<BN>(x, &wmap, &xmap, ring, full, empty, sh);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<BN, MODE>(scale, bias, y, ring, full, empty, turn, scratch, sh);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2colFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a function of libcuda, looked up through the runtime (so the library needs no -lcuda)
void* entry_point(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

template <int BN, int MODE>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* scale, const void* bias, void* y, const Shape& sh,
                   cudaStream_t stream) {
  static EncodeTiledFn encode_tiled = reinterpret_cast<EncodeTiledFn>(entry_point("cuTensorMapEncodeTiled"));
  static EncodeIm2colFn encode_im2col = reinterpret_cast<EncodeIm2colFn>(entry_point("cuTensorMapEncodeIm2col"));
  if (encode_tiled == nullptr || encode_im2col == nullptr) return cudaErrorNotSupported;
  // B: (Cout, K) int8, K contiguous; boxes of 128 bytes of K x BN rows, zero outside
  CUtensorMap wmap, xmap;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(sh.k_total), static_cast<cuuint64_t>(sh.cout)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(sh.k_total)};
  const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(BN)};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode_tiled(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), wdims, wstrides, wbox, ones,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // A (im2col): x as (C, W, H, N); base pixels from -pad to the last window's
  // corner, stepped by the stride; 128 channels x 64 pixels a load, zero outside
  memset(&xmap, 0, sizeof(xmap));
  if (sh.im2col) {
    const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(sh.cin), static_cast<cuuint64_t>(sh.w),
                                 static_cast<cuuint64_t>(sh.h), static_cast<cuuint64_t>(sh.n)};
    const cuuint64_t xstrides[3] = {static_cast<cuuint64_t>(sh.cin), static_cast<cuuint64_t>(sh.w) * sh.cin,
                                    static_cast<cuuint64_t>(sh.h) * sh.w * sh.cin};
    const int lower[2] = {-sh.pad, -sh.pad};
    const int upper[2] = {sh.pad - (sh.kw - 1), sh.pad - (sh.kh - 1)};
    const cuuint32_t estrides[4] = {1, static_cast<cuuint32_t>(sh.stride), static_cast<cuuint32_t>(sh.stride), 1};
    if (encode_im2col(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x), xdims, xstrides, lower, upper,
                      BK, Cfg<BN>::BM, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  // the SM count and the shared-memory opt-in, once per device
  static int sms_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(int8_conv_kernel<BN, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(Cfg<BN>::SMEM));
    if (err != cudaSuccess) return err;
    sms_of[dev] = sms;
  }
  const int grid = sh.tiles < sms_of[dev] ? sh.tiles : sms_of[dev];
  int8_conv_kernel<BN, MODE><<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(x, wmap, xmap, scale, bias, y, sh);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_mode(int mode, const int8_t* x, const int8_t* w, const float* scale, const void* bias, void* y,
                        const Shape& sh, cudaStream_t stream) {
  if (mode == 0) return launch<BN, 0>(x, w, scale, bias, y, sh, stream);
  if (mode == 1) return launch<BN, 1>(x, w, scale, bias, y, sh, stream);
  return launch<BN, 2>(x, w, scale, bias, y, sh, stream);
}

}  // namespace

// x (n, h, w, cin) int8; w (cout, kh, kw, cin) int8; scale (cout,) float32 or
// null in mode 0; bias (cout,) float32 (mode 1) or bfloat16 (mode 2) or null;
// y (n, ho, wo, cout) of the mode's type; x, w, scale, bias and y 16-byte
// aligned. Returns cudaGetLastError() after the launch (0 when it was
// accepted), or an error code for arguments the kernel does not take.
// Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int int8_conv_forward(const void* x, const void* w, const float* scale, const void* bias, void* y,
                                 int n, int h, int wd, int cin, int cout, int kh, int kw, int stride, int pad,
                                 int mode, cudaStream_t stream) {
  if (n < 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || pad < 0 ||
      cin % 32 != 0 || mode < 0 || mode > 2 || (mode != 0 && scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the producer packs a window's corner into two 16-bit halves and indexes rows as img * h + hi in 32 bits
  if (h + pad > 32767 || wd + pad > 32767 || static_cast<long long>(n) * h >= 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.n = n;
  sh.h = h;
  sh.w = wd;
  sh.cin = cin;
  sh.cout = cout;
  sh.kh = kh;
  sh.kw = kw;
  sh.stride = stride;
  sh.pad = pad;
  sh.ho = (h + 2 * pad - kh) / stride + 1;
  sh.wo = (wd + 2 * pad - kw) / stride + 1;
  if (sh.ho <= 0 || sh.wo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long k_total = static_cast<long long>(kh) * kw * cin;
  if (k_total > 0x7FFFFFFFLL - BK) return static_cast<int>(cudaErrorInvalidValue);
  sh.k_total = static_cast<int>(k_total);
  sh.ktiles = (sh.k_total + BK - 1) / BK;
  sh.m_total = static_cast<long long>(n) * sh.ho * sh.wo;
  if (sh.m_total == 0) return 0;
  // TMA's im2col box: corners and tap offsets within 8 bits (a 4-D map), the stride within its traversal limit
  sh.im2col = cin % BK == 0 && pad <= 127 && kh <= 128 && kw <= 128 && stride <= 8;
  const int bn = cout <= 128 ? 128 : 256;
  const int bm = bn == 128 ? Cfg<128>::BM : Cfg<256>::BM;
  sh.ntiles = (cout + bn - 1) / bn;
  const long long tiles = (sh.m_total + bm - 1) / bm * sh.ntiles;
  if (tiles > 0x7FFFFFFFLL || tiles * sh.ktiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  sh.tiles = static_cast<int>(tiles);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  const cudaError_t err = bn == 128 ? launch_mode<128>(mode, xs, ws, scale, bias, y, sh, stream)
                                    : launch_mode<256>(mode, xs, ws, scale, bias, y, sh, stream);
  return static_cast<int>(err);
}
