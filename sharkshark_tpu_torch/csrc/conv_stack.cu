// A stack of L x [3x3 SAME conv + bias + PReLU] layers at 64 channels in
// one launch, for NVIDIA Hopper (sm_90a), bf16 in and out, f32
// accumulate: SRVGG's body.
//
// Replaces: experiments/conv_stack.py::fused_conv_stack (the Pallas TPU
// kernel, which has no bias).  Same function as the port's plain version,
// sharkshark_tpu_torch/ops/conv_stack.py::fused_conv_stack_plain: each
// layer accumulates in f32, adds its f32 bias, applies PReLU with
// per-channel f32 alpha, and rounds once to bf16.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at SRVGG's
// shape (4, 720, 1280, 64): one layer is 2*9*64*64*N*H*W = 2.72e11 FLOP
// -> 0.275 ms, and x read + out written once is 0.94 GB -> 0.282 ms, so L
// layers are bounded by max(0.275 L, 0.282) ms.  Run one launch per layer,
// the body is bytes-bound; L >= 2 makes it operations-bound.  (chip_smoke.py
// recomputes the bound from the tensors it launches on.)
//
// Two kernels, chosen by L.
//
// L = 1, the SRVGG body's route (conv_one_kernel): K1's C=64 design
// (csrc/tsm_conv.cu) without the temporal shift.  Per 16 x 16 output
// tile it is an implicit GEMM: M = 256 pixels, N = 64 output channels,
// K = 9 taps x 64 input channels.
//   - Persistent blocks, one per SM and never more than tiles, each
//     walking tiles `gridDim.x` apart (walk order below).  A block loads
//     the layer's 9 x 64 x 64 weights once and keeps them resident
//     (73.7 KB), in wgmma's MN-major 128-byte-swizzle B layout: row
//     (tap, ci) of 64 output channels, 16-byte chunk v at v ^ (row % 8).
//   - The halo (18 x 18 pixels x 64 channels, 41.5 KB) comes by one TMA
//     box from a 4-d tensor map (channel, x, y, image) at (x0-1, y0-1), in
//     the 128-byte swizzle, into one of three buffers; TMA's zero fill
//     outside the tensor is the conv's SAME padding, and the image is the
//     4th dimension, so a halo never reads the next image's rows.
//   - Warp specialisation.  A producer warpgroup (one thread of it)
//     issues the loads as soon as the consumers hand a buffer back, so two
//     tiles load while one computes; it gives its registers away
//     (setmaxnreg).  An mbarrier a buffer says "loaded", a named barrier a
//     buffer "done".  Two consumer warpgroups each own 2 m64 tiles (8
//     output rows).  Per k16 step: A (64 pixels x 16 channels) by ldmatrix
//     from the halo at the tap's pixel offset, fetched two steps ahead; B
//     the resident tap by descriptor; wgmma m64n64k16 into f32 registers.
//     A tile's 36 k16 steps are unrolled.
//   - Epilogue from the accumulators: each thread holds the f32 bias and
//     alpha of its 16 columns in registers for the block's life; bias,
//     PReLU, one bf16 rounding, staged in the tile's own halo buffer (free
//     once both warpgroups are done with it); the producer writes it with
//     one TMA store, which clips at the image edge, before it reloads that
//     buffer.  Only the one layer writes, so no margin mask is needed.
//   - Shared memory: 1 KB alignment + 73.7 KB weights + 3 x 41 KB halo
//     buffers = 200 KB of the 227 KB.  A fourth buffer does not fit.
//   - Walk order: an image's tiles row by row, image after image, so that
//     the 132 tiles in flight cover about 1.7 tile rows of one image and
//     the two halo rows a tile shares with the tile below it are read
//     while they are in L2.  (Running the N images of one spatial tile on
//     neighbouring blocks measured no different at SRVGG's shape.)
//
// L >= 2 (conv_stack_kernel, tile per block): one block computes a TH x
// (32 - 2L) output tile of one image through all L layers.  It loads the
// input tile with an L-pixel halo into shared memory (zero outside the
// image) and runs layer l over the region that layers l+1.. still need,
// which shrinks by one pixel a side per layer (the TPU kernel's shrinking
// valid region).  Two buffers take turns as a layer's input and output;
// only the last layer writes to device memory, so activation traffic falls
// L-fold.
//   - Each layer is an implicit GEMM on the tensor cores (wmma 16x16x16,
//     f32 accumulators) over the region's pixels in row-major order at the
//     buffer's row width WB = 32: output pixel p reads input pixel
//     p + dy*WB + dx for tap (dy, dx), so a 16-pixel M tile is one strided
//     wmma load per tap, and the columns past a layer's valid width are
//     computed and dropped.
//   - Epilogue in f32: bias, PReLU, one bf16 rounding.  After every layer
//     but the last, positions outside the image are written as zero, so
//     the next layer sees SAME zero padding (the TPU kernel's margin mask).
//   - Weights are staged one tap (64 x 64) at a time, as a pipeline of
//     cp.async copies two taps ahead into three slots (one barrier per
//     tap); each warp holds up to 4 M tiles x 64 channels of f32
//     accumulators, so a layer's weights pass once or twice per block.
// Left out by design: the TPU kernel's pixel-pair lane folding and its
// block-structured weights, which exist for the TPU's 128-lane tiles.
// TH is the most rows that fit two buffers in shared memory: 14 for L = 3,
// 12 for L = 4 (L_MAX), else 16.  The halo recompute costs 1.2x (L=2) to
// 1.7x (L=4) the useful MACs; a tile wide enough that L > 1 pays is later
// work.
//
// The PTX wrappers below are copies of tsm_conv.cu's, so that this file
// builds on its own (the build hashes each source alone).

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int C = 64;
constexpr int L_MAX = 4;

__host__ __device__ constexpr int align_up(int v, int a) { return (v + a - 1) / a * a; }

// ------------------------------------------------------------ L >= 2

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NT = C / 16;      // a work item is one M tile x all 64 channels
constexpr int IT = 4;           // work items a warp holds at once
constexpr int WB = 32;          // buffer row width, pixels
constexpr int PIX = C + 16;     // pixel stride in elements (32-byte aligned for wmma)
constexpr int WLD = C + 8;
constexpr int WSLOTS = 3;       // weight taps in flight: the one in use and two loading
constexpr int WTAP = C * WLD;   // elements of one staged tap

__host__ __device__ constexpr int tile_rows(int L) { return 20 - 2 * L < 16 ? 20 - 2 * L : 16; }

struct Layout {
    int th, tw, pix_a, pix_b, off_b, off_w, off_st, smem;
};

__host__ __device__ inline Layout layout(int L)
{
    Layout s;
    s.th = tile_rows(L);
    s.tw = WB - 2 * L;
    s.pix_a = (s.th + 2 * L) * WB + 2;      // + 2: the last tap's overrun
    s.pix_b = (s.th + 2 * L - 2) * WB + 2;
    s.off_b = align_up(s.pix_a * PIX * 2, 128);
    s.off_w = s.off_b + align_up(s.pix_b * PIX * 2, 128);
    s.off_st = s.off_w + align_up(WSLOTS * WTAP * 2, 128);
    s.smem = s.off_st + WARPS * 256 * 4;
    return s;
}

// layer l's 16-pixel M tiles, and the passes ("chunks") it takes at IT
// tiles a warp; the chunks split the tiles evenly
__device__ __forceinline__ int layer_tiles(const Layout& s, int L, int l)
{
    return (s.th + 2 * (L - 1 - l)) * WB / 16;
}

__device__ __forceinline__ int layer_chunks(const Layout& s, int L, int l)
{
    return (layer_tiles(s, L, l) + WARPS * IT - 1) / (WARPS * IT);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gmem_src));
}

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(THREADS)
conv_stack_kernel(const __nv_bfloat16* __restrict__ x,      // (N, H, W, 64)
                  const __nv_bfloat16* __restrict__ w,      // (L, 3, 3, 64, 64) HWIO
                  const float* __restrict__ bias,           // (L, 64)
                  const float* __restrict__ alpha,          // (L, 64)
                  __nv_bfloat16* __restrict__ out,          // (N, H, W, 64)
                  int L, int H, int W)
{
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout s = layout(L);
    __nv_bfloat16* src = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(smem + s.off_b);
    __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + s.off_w);
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float* stage = reinterpret_cast<float*>(smem + s.off_st) + warp * 256;

    const int n = blockIdx.z;
    const int y0 = blockIdx.y * s.th;
    const int x0 = blockIdx.x * s.tw;
    const size_t plane = (size_t)H * W;
    constexpr int VEC = C / 8;

    // The weights run as one sequence of steps, (layer, chunk, tap), each
    // staging one tap into slot step % WSLOTS.  Step q + 2 is fetched with
    // cp.async while step q computes, so one barrier per step suffices.
    int steps = 0;
    for (int l = 0; l < L; ++l) steps += 9 * layer_chunks(s, L, l);
    auto fetch = [&](int q) {
        if (q < steps) {
            int l = 0, r = q;
            while (r >= 9 * layer_chunks(s, L, l)) r -= 9 * layer_chunks(s, L, l++);
            const __nv_bfloat16* wtap = w + ((size_t)l * 9 + r % 9) * C * C;
            __nv_bfloat16* slot = wsm + (q % WSLOTS) * WTAP;
            for (int i = threadIdx.x; i < C * C / 8; i += THREADS)
                cp_async16(slot + (i / (C / 8)) * WLD + (i % (C / 8)) * 8, wtap + i * 8);
        }
        asm volatile("cp.async.commit_group;\n" ::);
    };
    fetch(0);
    fetch(1);

    // the input tile with an L-pixel halo: (r, c) <-> (y0 - L + r, x0 - L + c)
    for (int i = threadIdx.x; i < s.pix_a * VEC; i += THREADS) {
        const int v = i % VEC;
        const int p = i / VEC;
        const int gy = y0 - L + p / WB;
        const int gx = x0 - L + p % WB;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (p < s.pix_a - 2 && gy >= 0 && gy < H && gx >= 0 && gx < W)
            val = __ldg(reinterpret_cast<const uint4*>(x + ((size_t)n * plane + (size_t)gy * W + gx) * C + v * 8));
        *reinterpret_cast<uint4*>(src + p * PIX + v * 8) = val;
    }
    for (int i = threadIdx.x; i < 2 * VEC; i += THREADS)
        *reinterpret_cast<uint4*>(dst + (s.pix_b - 2 + i / VEC) * PIX + (i % VEC) * 8) =
            make_uint4(0u, 0u, 0u, 0u);

    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[NT];
    const int px = lane / 2;
    const int hi = lane % 2;
    int q = 0;  // weight step
    for (int l = 0; l < L; ++l) {
        // layer l's output (r, c) <-> (y0 - L + 1 + l + r, x0 - L + 1 + l + c);
        // rows the later layers need, columns valid below `valid`
        const int nmt = layer_tiles(s, L, l);
        const int nch = layer_chunks(s, L, l);
        const int per = (nmt + nch - 1) / nch;  // tiles per chunk
        const int valid = WB - 2 * (l + 1);
        const int oy = y0 - L + 1 + l;
        const int ox = x0 - L + 1 + l;
        const bool last = l == L - 1;
        for (int ch = 0; ch < nch; ++ch) {
            const int first = ch * per;
            const int end = min(first + per, nmt);
            AccFrag acc[IT][NT];
#pragma unroll
            for (int it = 0; it < IT; ++it)
#pragma unroll
                for (int b = 0; b < NT; ++b) wmma::fill_fragment(acc[it][b], 0.0f);
            for (int tap = 0; tap < 9; ++tap, ++q) {
                const int shift = (tap / 3) * WB + tap % 3;
                // this thread's copies of step q are done (only q + 1 may be
                // pending); the barrier makes everyone's visible, and every
                // warp is past step q - 1, whose slot step q + 2 refills;
                // it also publishes the input tile / the last layer's output
                asm volatile("cp.async.wait_group 1;\n" ::);
                __syncthreads();
                fetch(q + 2);
                const __nv_bfloat16* wq = wsm + (q % WSLOTS) * WTAP;
#pragma unroll
                for (int kb = 0; kb < C / 16; ++kb) {
#pragma unroll
                    for (int b = 0; b < NT; ++b)
                        wmma::load_matrix_sync(fb[b], wq + kb * 16 * WLD + b * 16, WLD);
#pragma unroll
                    for (int it = 0; it < IT; ++it) {
                        const int mt = first + warp + it * WARPS;
                        if (mt < end) {
                            wmma::load_matrix_sync(fa, src + (mt * 16 + shift) * PIX + kb * 16, PIX);
#pragma unroll
                            for (int b = 0; b < NT; ++b) wmma::mma_sync(acc[it][b], fa, fb[b], acc[it][b]);
                        }
                    }
                }
            }
            // epilogue: lane -> (pixel lane/2, 8-channel half lane%2)
#pragma unroll
            for (int it = 0; it < IT; ++it) {
                const int mt = first + warp + it * WARPS;
                if (mt >= end) continue;
                const int p = mt * 16 + px;
                const int r = p / WB;
                const int c = p % WB;
                const int gy = oy + r;
                const int gx = ox + c;
                const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
                for (int b = 0; b < NT; ++b) {
                    wmma::store_matrix_sync(stage, acc[it][b], 16, wmma::mem_row_major);
                    __syncwarp();
                    const int c0 = b * 16 + hi * 8;
                    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        float y = stage[px * 16 + hi * 8 + e] + bias[l * C + c0 + e];
                        y = y >= 0.0f ? y : y * alpha[l * C + c0 + e];
                        // SAME zero padding for the next layer
                        v[e] = __float2bfloat16(inside ? y : 0.0f);
                    }
                    const uint4 packed = *reinterpret_cast<const uint4*>(v);
                    if (!last) {
                        if (c < valid) *reinterpret_cast<uint4*>(dst + p * PIX + c0) = packed;
                    } else if (c < s.tw && inside) {
                        *reinterpret_cast<uint4*>(out + ((size_t)n * plane + (size_t)gy * W + gx) * C + c0) = packed;
                    }
                    __syncwarp();
                }
            }
        }
        __nv_bfloat16* tmp = src;
        src = dst;
        dst = tmp;
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// ------------------------------------------------------------- L = 1

namespace one {

constexpr int CONSUMERS = 256;            // two warpgroups: the MMAs and the epilogue
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup: the TMA copies
constexpr int TH = 16, TW = 16;           // output tile
constexpr int HH = TH + 2, HW = TW + 2;   // its halo
constexpr int PH = HH * HW;               // halo pixels
constexpr int ROW = C * 2;                // bytes of a pixel, a weight row, an output pixel
constexpr int NBUF = 3;                   // halo buffers
constexpr int MT = TH * TW / 64 / 2;      // m64 tiles per consumer warpgroup
constexpr int A_SETS = 3;                 // register sets of A: fetched two k16 steps ahead
constexpr int STEPS = 9 * C / 16;         // k16 steps of a tile
constexpr int W_BYTES = 9 * C * ROW;
constexpr int HALO_BYTES = PH * ROW;
constexpr int BUF = align_up(HALO_BYTES, 1024);  // buffers on the 128-byte swizzle's 1024-byte atom
// + 1024: the weights start on a 1024-byte boundary; then the buffers,
// and an mbarrier for each
constexpr int SMEM = 1024 + W_BYTES + (NBUF - 1) * BUF + HALO_BYTES + 8 * NBUF;
static_assert(W_BYTES % 1024 == 0, "the halo buffers start on a swizzle atom");
static_assert(TH * TW * ROW <= HALO_BYTES, "a tile's outputs stage in its halo buffer");
static_assert(TW == 16, "an m16 tile is one output row");
static_assert(MT * 2 * 64 == TH * TW, "whole m64 tiles per warpgroup");
static_assert(SMEM <= 232448, "fits one SM's shared memory");

// named barriers (0 is __syncthreads): EMPTY + b (b < NBUF), the
// consumers are done with halo buffer b and have staged its tile's
// outputs there; CONS, the two consumer warpgroups alone
constexpr int EMPTY = 1;
constexpr int CONS = EMPTY + NBUF;

__device__ __forceinline__ unsigned smem_u32(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void mbar_init(unsigned mb, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mb), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned mb, int bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned mb, int phase)
{
    unsigned done;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(mb), "r"(phase)
            : "memory");
    } while (!done);
}

// one box of a 4-d tensor map at (channel, x, y, image) into shared
// memory; outside the tensor the box reads zeros
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap& map, int c, int x, int y, int img, unsigned mb)
{
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c), "r"(x), "r"(y), "r"(img), "r"(mb)
        : "memory");
}

// a tile's staged outputs (rows of 128 bytes, 128-byte swizzle) from
// shared memory to the tensor at (channel, x, y, image); the part of the
// box outside the tensor is not written
__device__ __forceinline__ void tma_store(const CUtensorMap& map, unsigned src, int c, int x, int y, int img)
{
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n"
        "cp.async.bulk.commit_group;\n"
        "cp.async.bulk.wait_group.read 0;\n"
        ::"l"(reinterpret_cast<uint64_t>(&map)), "r"(c), "r"(x), "r"(y), "r"(img), "r"(src)
        : "memory");
}

template <int COUNT>
__device__ __forceinline__ void bar_sync(int id)
{
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(COUNT) : "memory");
}

template <int COUNT>
__device__ __forceinline__ void bar_arrive(int id)
{
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(COUNT) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4])
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// B descriptor of one k16 step: 16 rows (input channels) x 64 output
// channels at `addr`, rows of 128 bytes, MN-major with the 128-byte
// swizzle (chunk v of row r at v ^ (r % 8), rows from a 1024-byte
// boundary): next 8 rows at 1024 bytes (SBO); one 64-channel atom, so
// the leading offset is unused
__device__ __forceinline__ uint64_t b_desc(unsigned addr)
{
    return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
           ((uint64_t)1 << 62);
}

// d += a (64 x 16, registers: this warp's 16 rows, mma.m16n8k16's A
// layout) x b (16 x 64, shared memory), the warpgroup's 64 x 64 f32 sums
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], const uint32_t (&a)[4], uint64_t b)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// keeps the compiler from moving reads of an accumulator above a wait
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

struct Tile {
    int n, y0, x0;
};

// Tile `tile` of the walk: image by image, each row by row.
__device__ __forceinline__ Tile tile_at(int tile, int tiles_x, int per_image)
{
    Tile t;
    t.n = tile / per_image;
    const int r = tile % per_image;
    t.x0 = (r % tiles_x) * TW;
    t.y0 = (r / tiles_x) * TH;
    return t;
}

// Tensor maps of x (boxes of the 18 x 18 halo) and out (boxes of the
// 16 x 16 tile), both 64 channels x W x H x N.
struct Maps {
    CUtensorMap x, out;
};

__global__ void __launch_bounds__(THREADS, 1)
conv_one_kernel(const __grid_constant__ Maps maps,
                const __nv_bfloat16* __restrict__ w,   // (3, 3, 64, 64) HWIO
                const float* __restrict__ bias,        // (64,)
                const float* __restrict__ alpha,       // (64,)
                int tiles_x, int per_image, int tiles)
{
    extern __shared__ __align__(1024) unsigned char smem[];
    const unsigned wsm = (smem_u32(smem) + 1023) & ~1023u;
    const unsigned halo = wsm + W_BYTES;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int stages = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;  // tiles of this block
    const unsigned full0 = halo + (NBUF - 1) * BUF + HALO_BYTES;
    if (tid == 0) {
        for (int b = 0; b < NBUF; ++b) mbar_init(full0 + 8 * b, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }

    // resident weights: row (tap, ci) holds the 64 output channels, 128
    // bytes, 16-byte chunk v at v ^ (row % 8); the proxy fence makes the
    // copies visible to wgmma
    for (int i = tid; i < 9 * C * 8; i += THREADS) {
        const int row = i / 8;
        const int v = i % 8;
        cp_async16(wsm + row * ROW + ((v ^ (row & 7)) << 4), w + (size_t)row * C + v * 8);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    if (tid >= CONSUMERS) {
        // registers go to the consumers: 2 x 128 x 232 + 128 x 40 <= 65,536
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::);
        // The producer: tile s's halo into buffer s % NBUF once the
        // consumers are done with tile s - NBUF, whose outputs (staged
        // there) first go out by TMA store.
        for (int s = 0; s < stages + NBUF; ++s) {
            if (s >= NBUF) bar_sync<THREADS>(EMPTY + s % NBUF);
            if (tid != CONSUMERS) continue;
            const unsigned buf = halo + (s % NBUF) * BUF;
            if (s >= NBUF) {
                const Tile t = tile_at(blockIdx.x + (s - NBUF) * gridDim.x, tiles_x, per_image);
                tma_store(maps.out, buf, 0, t.x0, t.y0, t.n);
            }
            if (s >= stages) continue;
            const Tile t = tile_at(blockIdx.x + s * gridDim.x, tiles_x, per_image);
            const unsigned mb = full0 + (s % NBUF) * 8;
            mbar_expect(mb, HALO_BYTES);
            tma_load(buf, maps.x, 0, t.x0 - 1, t.y0 - 1, t.n, mb);
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::);
    // Warpgroup wg (warps 4wg..4wg+3) owns the tile's m64 tiles
    // wg*MT..wg*MT+MT-1, 4 output rows each; warp wi of it owns row wi of
    // each (an m16 tile) for its A fragments and accumulators.  ldmatrix
    // (x4) lane -> pixel lane % 16 of the row, k half lane / 16.
    const int wg = warp / 4;
    const int wi = warp % 4;
    const int a_px = lane & 15;
    const int a_hi = lane >> 4;
    int a_p[MT];  // this lane's halo pixel in each of its rows at tap (0, 0)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) a_p[mt] = ((wg * MT + mt) * 4 + wi) * HW + a_px;

    // accumulator 4jn+e holds (pixel g + 8*(e/2), channel 8jn + 2q + e%2):
    // the bias and alpha of this thread's 16 channels, for the block's life
    const int q = lane & 3;
    const int g = lane >> 2;
    float2 bv[8], av[8];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
        bv[jn] = *reinterpret_cast<const float2*>(bias + jn * 8 + 2 * q);
        av[jn] = *reinterpret_cast<const float2*>(alpha + jn * 8 + 2 * q);
    }

    float acc[MT][32];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[mt][e] = 0.0f;

    for (int s = 0; s < stages; ++s) {
        // each warpgroup waits for a tile on its own
        mbar_wait(full0 + (s % NBUF) * 8, (s / NBUF) & 1);
        const unsigned buf = halo + (s % NBUF) * BUF;

        // 36 k16 steps (9 taps x 4 channel blocks).  A goes through A_SETS
        // register sets: once step k-1's wgmmas are done, A of step
        // k+A_SETS-1 loads into their set while step k's run.  Halo pixel
        // p's chunk v (channels 8v..8v+7) is at p*128 + (v ^ (p % 8))*16,
        // TMA's 128-byte swizzle.
        uint32_t a[A_SETS][MT][4];
        auto load_a = [&](int k, uint32_t (&dst)[MT][4]) {
            const int tap = k / 4;
            const int v = (k % 4) * 2 + a_hi;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                const int p = a_p[mt] + (tap / 3) * HW + tap % 3;
                ldsm_x4(buf + p * ROW + ((v ^ (p & 7)) << 4), dst[mt]);
            }
        };
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 32; ++e) fence_operand(acc[mt][e]);
#pragma unroll
        for (int k = 0; k < A_SETS - 1; ++k) load_a(k, a[k]);
#pragma unroll
        for (int k = 0; k < STEPS; ++k) {
            const unsigned wt = wsm + ((k / 4) * C + (k % 4) * 16) * ROW;
            wgmma_fence();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) wgmma_64x64x16(acc[mt], a[k % A_SETS][mt], b_desc(wt));
            wgmma_commit();
            wgmma_wait<1>();  // step k-1 is done with its register set
            if (k + A_SETS - 1 < STEPS) load_a(k + A_SETS - 1, a[(k + A_SETS - 1) % A_SETS]);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 32; ++e) fence_operand(acc[mt][e]);

        // epilogue: bias, PReLU, bf16 into the tile's buffer once both
        // warpgroups are done reading it: output pixel p of the tile
        // (row-major) at p*128 bytes, chunk jn at jn ^ (p % 8), the TMA
        // store's 128-byte swizzle; the producer stores it.
        bar_sync<CONSUMERS>(CONS);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const int m = (wg * MT + mt) * 4 + wi;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int p = m * TW + g + 8 * half;  // p % 8 == g
#pragma unroll
                for (int jn = 0; jn < 8; ++jn) {
                    float v0 = acc[mt][4 * jn + 2 * half] + bv[jn].x;
                    float v1 = acc[mt][4 * jn + 2 * half + 1] + bv[jn].y;
                    v0 = v0 >= 0.0f ? v0 : v0 * av[jn].x;
                    v1 = v1 >= 0.0f ? v1 : v1 * av[jn].y;
                    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(buf + p * ROW + ((jn ^ g) << 4) + q * 4),
                                 "r"(pack_bf16(v0, v1)) : "memory");
                }
            }
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[mt][e] = 0.0f;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the writes, for the TMA store
        bar_arrive<THREADS>(EMPTY + s % NBUF);
    }
}

// The persistent grid: tiles of the batch, and blocks to launch, never
// more than SMs or tiles.
cudaError_t schedule(int N, int H, int W, int* tiles_x, int* per_image, int* tiles, int* blocks)
{
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    *tiles_x = (W + TW - 1) / TW;
    *per_image = *tiles_x * ((H + TH - 1) / TH);
    *tiles = N * *per_image;
    *blocks = sms < *tiles ? sms : *tiles;
    return cudaSuccess;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 (N, H, W, 64) tensor as a 4-d map (channel, x, y, image) whose
// boxes are 64 x box_w x box_h x 1, rows of 128 bytes in the 128-byte
// swizzle.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int W, int H, int N, int box_w, int box_h)
{
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t strides[3] = {(cuuint64_t)ROW, (cuuint64_t)ROW * W, (cuuint64_t)ROW * W * H};
    const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const void* x, const void* w, const void* bias, const void* alpha, void* out,
                   int N, int H, int W, cudaStream_t stream)
{
    // the tensor-map encoder (cuTensorMapEncodeTiled), found once through the runtime
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || !p) return cudaErrorSymbolNotFound;
        fn = reinterpret_cast<EncodeTiled>(p);
    }
    Maps maps;
    if (!encode(fn, &maps.x, x, W, H, N, HW, HH) || !encode(fn, &maps.out, out, W, H, N, TW, TH))
        return cudaErrorNotSupported;
    // above 48 KB a block needs the opt-in, once per process
    static bool configured = false;
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(conv_one_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    int tiles_x, per_image, tiles, blocks;
    cudaError_t err = schedule(N, H, W, &tiles_x, &per_image, &tiles, &blocks);
    if (err != cudaSuccess) return err;
    conv_one_kernel<<<blocks, THREADS, SMEM, stream>>>(
        maps, static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
        static_cast<const float*>(alpha), tiles_x, per_image, tiles);
    return cudaGetLastError();
}

}  // namespace one

cudaError_t launch_stack(const void* x, const void* w, const void* bias, const void* alpha, void* out,
                         int N, int H, int W, int L, cudaStream_t stream)
{
    const Layout s = layout(L);
    // above 48 KB a block needs the opt-in; raise it to the largest layout
    static int configured = 0;
    if (configured < s.smem) {
        int most = 0;
        for (int l = 2; l <= L_MAX; ++l) most = layout(l).smem > most ? layout(l).smem : most;
        cudaError_t err = cudaFuncSetAttribute(conv_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (err != cudaSuccess) return err;
        configured = most;
    }
    dim3 grid((W + s.tw - 1) / s.tw, (H + s.th - 1) / s.th, N);
    conv_stack_kernel<<<grid, THREADS, s.smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(alpha),
        static_cast<__nv_bfloat16*>(out), L, H, W);
    return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  x and out (N, H, W, 64) bf16, 16-byte aligned;
// w (L, 3, 3, 64, 64) bf16; bias and alpha (L, 64) f32.  L = 1 runs the
// persistent kernel, 2..L_MAX the tile-per-block one.  Returns the
// cudaError_t of the launch (0 on success); L outside [1, L_MAX] or an
// empty shape returns cudaErrorInvalidValue, a tensor map that
// cuTensorMapEncodeTiled refuses cudaErrorNotSupported.
extern "C" int conv_stack_bf16(const void* x, const void* w, const void* bias, const void* alpha,
                               void* out, int N, int H, int W, int L, void* stream)
{
    if (L < 1 || L > L_MAX || N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (L == 1) return (int)one::launch(x, w, bias, alpha, out, N, H, W, s);
    return (int)launch_stack(x, w, bias, alpha, out, N, H, W, L, s);
}

// The grid conv_stack_bf16 launches for a shape on the current device:
// output tiles and blocks.  At L = 1 the blocks are persistent (at most
// one per SM, never more than tiles) and walk the tiles; at L >= 2 each
// block computes one tile.  Same return codes.
extern "C" int conv_stack_schedule(int N, int H, int W, int L, int* tiles, int* blocks)
{
    if (L < 1 || L > L_MAX || N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    if (L == 1) {
        int tiles_x, per_image;
        return (int)one::schedule(N, H, W, &tiles_x, &per_image, tiles, blocks);
    }
    const Layout s = layout(L);
    *tiles = *blocks = ((W + s.tw - 1) / s.tw) * ((H + s.th - 1) / s.th) * N;
    return (int)cudaSuccess;
}
