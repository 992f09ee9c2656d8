// A stack of L x [3x3 SAME conv + bias + PReLU] layers at 64 channels,
// for NVIDIA Hopper (sm_90a), bf16 in and out, f32 accumulate: SRVGG's
// body.
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
// layers are bounded by max(0.275 L, 0.282) ms.  (chip_smoke.py
// recomputes the bound from the tensors it launches on.)
//
// L layers run as L launches of one kernel, each one layer (conv_one_kernel
// below), ping-ponging between out and a scratch buffer of x's shape so
// that the last layer writes out.  At C = 64 one layer sits on the card's
// ridge: its operations (0.275 ms) and its bytes (0.282 ms) bound it
// alike.  Fusing L layers in one launch would save only the intermediate
// activations' traffic, at most 2.5 % of the bound at L = 2 (0.5496 ms
// fused against 2 x 0.2817 chained), and the shrinking halo of a fused
// tile recomputes 1.2x (L = 2) to 1.7x (L = 4) the useful MACs at the
// tile sizes shared memory allows (a fused tile-per-block kernel measured
// 4.75 / 11.99 ms at L = 2 / 4 against 3.99 / 7.69 layer by layer through
// cuDNN, NVIDIA H100 80GB HBM3, 700 W).  So on this card chained launches of the
// fastest one-layer kernel are the design; the plain version rounds to
// bf16 after every layer, so they compute the same function.
//
// The one-layer kernel: K1's C=64 design (csrc/tsm_conv.cu) without the
// temporal shift.  Per 16 x 16 output tile it is an implicit GEMM: M =
// 256 pixels, N = 64 output channels, K = 9 taps x 64 input channels.
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
//     buffer.
//   - Shared memory: 1 KB alignment + 73.7 KB weights + 3 x 41 KB halo
//     buffers = 200 KB of the 227 KB.  A fourth buffer does not fit.
//   - Walk order: an image's tiles row by row, image after image, so that
//     the 132 tiles in flight cover about 1.7 tile rows of one image and
//     the two halo rows a tile shares with the tile below it are read
//     while they are in L2.  (Running the N images of one spatial tile on
//     neighbouring blocks measured no different at SRVGG's shape.)
//
// The PTX wrappers below are copies of tsm_conv.cu's, so that this file
// builds on its own (the build hashes each source alone).

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;
// the deepest stack a call takes: the depths its callers run and are
// tested at (chained launches set no limit of their own)
constexpr int L_MAX = 4;

__host__ __device__ constexpr int align_up(int v, int a) { return (v + a - 1) / a * a; }

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

// L layers as L launches on `stream`: layer l reads x or the previous
// layer's output and writes out or scratch, in turns that end on out.
cudaError_t launch(const void* x, const void* w, const void* bias, const void* alpha, void* out, void* scratch,
                   int N, int H, int W, int L, cudaStream_t stream)
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
    // each buffer's maps once a call, halo boxes to read it and tile boxes
    // to write it: the maps of the first layer's input, and of a layer that
    // writes out (reading scratch) or scratch (reading out)
    CUtensorMap from_x;
    Maps to_out, to_scratch;
    if (!encode(fn, &from_x, x, W, H, N, HW, HH) || !encode(fn, &to_out.out, out, W, H, N, TW, TH))
        return cudaErrorNotSupported;
    if (L > 1 && (!encode(fn, &to_out.x, scratch, W, H, N, HW, HH) || !encode(fn, &to_scratch.x, out, W, H, N, HW, HH) ||
                  !encode(fn, &to_scratch.out, scratch, W, H, N, TW, TH)))
        return cudaErrorNotSupported;
    // above 48 KB a block needs the opt-in, once per device: the attribute
    // belongs to the current device's context
    constexpr int MAX_DEVICES = 64;
    static bool configured[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES || !configured[dev]) {
        err = cudaFuncSetAttribute(conv_one_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (err != cudaSuccess) return err;
        if (dev < MAX_DEVICES) configured[dev] = true;
    }
    int tiles_x, per_image, tiles, blocks;
    err = schedule(N, H, W, &tiles_x, &per_image, &tiles, &blocks);
    if (err != cudaSuccess) return err;
    for (int l = 0; l < L; ++l) {
        // layer L-1 writes out, L-2 scratch, L-3 out...; each reads what the
        // one before it wrote
        Maps maps = (L - 1 - l) % 2 == 0 ? to_out : to_scratch;
        if (l == 0) maps.x = from_x;
        conv_one_kernel<<<blocks, THREADS, SMEM, stream>>>(
            maps, static_cast<const __nv_bfloat16*>(w) + (size_t)l * 9 * C * C,
            static_cast<const float*>(bias) + l * C, static_cast<const float*>(alpha) + l * C, tiles_x,
            per_image, tiles);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

}  // namespace

// C interface for ctypes.  x, out and scratch (N, H, W, 64) bf16, 16-byte
// aligned, three separate buffers (scratch is unused, and may be null, at
// L = 1); w (L, 3, 3, 64, 64) bf16; bias and alpha (L, 64) f32.  Runs
// the L layers as L launches of the one-layer kernel on `stream`.
// Returns the cudaError_t of the launches (0 on success); L outside
// [1, L_MAX], an empty shape, out = x, or (at L > 1) a null scratch or
// one that is x or out return cudaErrorInvalidValue, a tensor map that
// cuTensorMapEncodeTiled refuses cudaErrorNotSupported.
extern "C" int conv_stack_bf16(const void* x, const void* w, const void* bias, const void* alpha,
                               void* out, void* scratch, int N, int H, int W, int L, void* stream)
{
    if (L < 1 || L > L_MAX || N < 1 || H < 1 || W < 1 || out == x) return (int)cudaErrorInvalidValue;
    if (L > 1 && (scratch == nullptr || scratch == x || scratch == out)) return (int)cudaErrorInvalidValue;
    return (int)launch(x, w, bias, alpha, out, L > 1 ? scratch : nullptr, N, H, W, L, static_cast<cudaStream_t>(stream));
}

// The grid of each of conv_stack_bf16's launches for a shape on the
// current device, the same at every L: output tiles, and persistent
// blocks (at most one per SM, never more than tiles) that walk them.
// Same return codes.
extern "C" int conv_stack_schedule(int N, int H, int W, int L, int* tiles, int* blocks)
{
    if (L < 1 || L > L_MAX || N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    int tiles_x, per_image;
    return (int)schedule(N, H, W, &tiles_x, &per_image, tiles, blocks);
}
