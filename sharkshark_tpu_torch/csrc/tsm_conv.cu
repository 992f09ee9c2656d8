// Temporal-shift 3x3 conv over a T-frame chunk (BSVD's buffered convs),
// for NVIDIA Hopper (sm_90a), bf16 in and out, f32 accumulate.
//
// Replaces: sharkshark_tpu/ops/pallas/tsm_conv.py::tsm_conv (the Pallas
// TPU kernel).  Same function as the port's plain version,
// sharkshark_tpu_torch/ops/tsm_conv.py::tsm_conv_plain.
//
// What it computes.  x holds a chunk of frames [a, a+T) of one layer's
// input, prev1 = x_{a-1} and left0 = x_{a-2}[..., fold:2fold] with
// fold = C/8.  Output j = act(conv3x3_zeropad(m_j) + b), where m_j is
//   channels [0, fold)     of x_j          (one frame of lookahead),
//   channels [fold, 2fold) of frame j-2    (left0 for j=0, prev1 for j=1),
//   channels [2fold, C)    of frame j-1    (prev1 for j=0).
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s), at the main
// path's shapes (720p input, T=4, N=1), derived from the data sheet:
//   C=64,  360x640: 2*9*C*C*H*W*T = 6.8e10 FLOP -> 69 us; bytes moved
//                   (x, prev1, left0 read once, out written once)
//                   ~= 2.69e8 -> 80 us.                 bytes-bound, ~80 us.
//   C=128, 180x320: 6.8e10 FLOP -> 69 us; ~1.35e8 B -> 40 us.
//                                                  operations-bound, ~69 us.
//   (chip_smoke.py recomputes both from the tensors it launches on.)
//
// Design.  The TPU kernel exists for two points: it builds the channel
// mix on chip instead of writing the mixed tensor to HBM and reading it
// back, and it keeps all 9 weight taps resident in fast memory for the
// whole grid.  This kernel keeps both and nothing of the TPU layout (no
// lane packing, no pair-shift weight blocks).  Per output tile it is an
// implicit GEMM: M = the tile's pixels, N = 64 output channels, K = 9*C.
//   - Persistent blocks, one per SM (200 KB of shared memory at C=64,
//     227 KB at C=128), never more than there are tiles.  A block owns 64 output
//     channels and keeps their 9 x C x 64 weights resident for its whole
//     life, loaded once: 73.7 KB at C=64, 147 KB at C=128.  All 128
//     output channels at C=128 (295 KB) do not fit 227 KB, so there
//     blocks come in pairs, one per half, walking the same tiles at the
//     same time.  Byte reckoning at C=128, 180x320, T=4: each halo is
//     read twice, 2 x 1.27 x 59 MB = 150 MB from L2 (the second read of a
//     pair a hit; DRAM about 59 MB), and the weights 132 x 147 KB = 19 MB
//     once, where the first version restaged 1,840 x 295 KB = 543 MB of
//     weights from L2 and streaming all 128 channels' taps through a ring
//     would still move 960 x 295 KB = 283 MB.
//   - Each block walks tiles of 16 x 16 output pixels (the 18 x 18 halo
//     is read 1.27x), image fastest: the T*N images of a spatial tile run
//     at about the same time on neighbouring blocks, so the channel
//     slices that different frames' tiles read from one pixel (16 bytes
//     each, one 32-byte sector) come from HBM once.  A stage is 64 input
//     channels of a tile's halo: one a tile at C=64, two at C=128.
//   - Warp specialisation.  A producer warpgroup (one thread of it) loads
//     each stage into one of NBUF shared-memory buffers (3 at C=64, where
//     the weights leave room, else 2) by TMA as soon as the consumers hand
//     the buffer back, so later stages load while stage s computes: one box per channel range, from the frame the range
//     names, at the halo's corner (x0-1, y0-1); TMA's zero fill outside
//     the tensor is the conv's zero padding.  An mbarrier a buffer says
//     "loaded", a named barrier a buffer "done".  The producer gives its registers
//     to the consumers (setmaxnreg).
//   - Two consumer warpgroups each own half the tile's pixels (2 or 4
//     m64 tiles) and wait for a stage each on its own.  Per k16 step: A
//     (64 pixels x 16 channels) by ldmatrix straight from the halo at the
//     tap's pixel offset into registers, B (the tap's 16 x 64 weights) by
//     a shared-memory descriptor, wgmma m64n64k16 into f32 registers.  A
//     stage's 36 k16 steps are unrolled, and A is fetched two steps ahead
//     of its wgmmas.  Every shared-memory row is in the TMA / wgmma
//     swizzle its width allows, so ldmatrix of 8 consecutive pixels has
//     no bank conflict.
//   - Epilogue from the accumulator registers: bias, none/relu/relu6 in
//     f32, one bf16 rounding into the stage's buffer (free once both
//     warpgroups are done with it); the consumers go on to the next
//     stage, and the producer stores the tile by TMA (which writes only
//     the part inside the image) before it reloads that buffer.
//   - Why 16 x 16 and not a wider tile with less halo re-read: a 16 x 32
//     tile's stage is 18 x 34 x 64 channels = 78 KB, so beside the
//     resident weights (73.7 / 147 KB) two such buffers do not fit 227 KB.
//     Why the epilogue goes through shared memory: so that the global
//     writes leave the consumers' critical path for the producer's TMA.

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 256;            // two warpgroups: the MMAs and the epilogue
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup: the halo copies
constexpr int NB = 64;       // output channels per block
constexpr int KC = 64;       // input channels per halo stage
constexpr int ROW = KC * 2;  // bytes of a weight row and of a staged output pixel

// named barriers (0 is __syncthreads): EMPTY + b (b < 3), the consumers
// are done with halo buffer b (and, after a tile's last stage, have
// staged its outputs there); CONS, the two consumer warpgroups alone
constexpr int EMPTY = 1;
constexpr int CONS = 4;

__host__ __device__ constexpr int align_up(int v, int a) { return (v + a - 1) / a * a; }

template <int C>
struct Shape {
    static constexpr int FOLD = C / 8;
    static constexpr int TH = 16;
    static constexpr int TW = 16;
    static constexpr int NBUF = C == 64 ? 3 : 2;  // halo buffers
    static constexpr int HH = TH + 2;
    static constexpr int HW = TW + 2;
    static constexpr int PH = HH * HW;                 // halo pixels
    static constexpr int NH = C / NB;                  // blocks per tile
    static constexpr int KCH = C / KC;                 // halo stages per tile
    static constexpr int MT = TH * TW / 64 / 2;        // m64 tiles per warpgroup
    static_assert(TW == 16, "an m16 tile is one output row");
    static constexpr int A_SETS = 3;  // register sets of A: fetched two k16 steps ahead
    static constexpr int W_BYTES = 9 * C * ROW;
    // A stage's halo lands by TMA in planes, [pixel][channels] each, one
    // per box: F (channels [0, fold) of frame j), M ([fold, 2fold) of
    // frame j-2), RA (the next 32 channels, of frame j-1) in the first
    // stage, RB (the last RB_BOX channels, of frame j-1) in the last; each
    // plane in the widest TMA swizzle its row fits (none for 16 bytes,
    // then 32, 64, 128), so that ldmatrix of 8 consecutive pixels has no
    // bank conflict.  Offsets in a buffer; buffer b starts at b * BUF.
    static constexpr int F_BOX = FOLD, RA_BOX = 32, RB_BOX = C == 64 ? 16 : 64;
    static constexpr int RA = 0;
    static constexpr int RB = C == 64 ? PH * RA_BOX * 2 : 0;  // at C=128 the second stage's only plane
    static constexpr int F = C == 64 ? RB + PH * RB_BOX * 2 : PH * RA_BOX * 2;
    static constexpr int M = F + align_up(PH * F_BOX * 2, F_BOX == 8 ? 128 : 256);
    static constexpr int END = M + PH * F_BOX * 2;
    static constexpr int BUF = align_up(END, 1024);
    static constexpr int FIRST_BYTES = PH * (2 * F_BOX + RA_BOX) * 2;  // first stage, all but RB
    static constexpr int LAST_BYTES = PH * RB_BOX * 2;
    // + 1024: the weights start on a 1024-byte boundary (the swizzle
    // atom); then the buffers, and an mbarrier for each
    static constexpr int SMEM = 1024 + W_BYTES + (NBUF - 1) * BUF + END + 8 * NBUF;
    static_assert(2 * F_BOX + RA_BOX + (C == 64 ? RB_BOX : 0) == KC, "the first stage's boxes cover 64 channels");
    static_assert(RB % (C == 64 ? 256 : 1024) == 0 && F % (C == 64 ? 128 : 256) == 0 &&
                      M % (C == 64 ? 128 : 256) == 0,
                  "TMA destinations on their swizzle's boundary");
    static_assert(RB + LAST_BYTES <= END, "the last stage's plane fits the buffer");
    static_assert(TH * TW * ROW <= END, "a tile's outputs stage in a halo buffer");
    static_assert(FOLD % 8 == 0, "channel ranges must be whole 8-channel vectors");
    static_assert(MT * 2 * 64 == TH * TW, "whole m64 tiles per warpgroup");
    static_assert(SMEM <= 232448, "fits one SM's shared memory");
};

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
    int j, n, y0, x0;
};

// Tensor maps of the three inputs, viewed as (channel, x, y, image): x
// (images T*N), prev1 and left0 (images N); one per box width.
struct Maps {
    CUtensorMap xF, xRA, xRB, pF, pRA, pRB, lF;
    CUtensorMap out;  // the output, boxes of 64 channels x TW x TH
};

// Shared-memory address of chunk v (channels 8v..8v+7 of the stage) of
// halo pixel p in the buffer at `buf`, in the stage's plane layout.
template <int C>
__device__ __forceinline__ unsigned a_addr(unsigned buf, int kc, int p, int v)
{
    using S = Shape<C>;
    if (C == 128 && kc == 1) return buf + S::RB + p * 128 + ((v ^ (p & 7)) << 4);
    if (C == 64) {
        if (v == 0) return buf + S::F + p * 16;
        if (v == 1) return buf + S::M + p * 16;
        if (v < 6) return buf + S::RA + p * 64 + (((v - 2) ^ ((p >> 1) & 3)) << 4);
        return buf + S::RB + p * 32 + (((v - 6) ^ ((p >> 2) & 1)) << 4);
    }
    if (v < 2) return buf + S::F + p * 32 + ((v ^ ((p >> 2) & 1)) << 4);
    if (v < 4) return buf + S::M + p * 32 + (((v - 2) ^ ((p >> 2) & 1)) << 4);
    return buf + S::RA + p * 64 + (((v - 4) ^ ((p >> 1) & 3)) << 4);
}

// Tiles run image-fastest: the T*N images of one spatial tile go to
// neighbouring blocks at about the same time.
template <int C>
__device__ __forceinline__ Tile tile_at(int tile, int N, int images, int tiles_x)
{
    using S = Shape<C>;
    Tile t;
    const int z = tile % images;
    tile /= images;
    t.j = z / N;
    t.n = z % N;
    t.x0 = (tile % tiles_x) * S::TW;
    t.y0 = (tile / tiles_x) * S::TH;
    return t;
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
tsm_conv_kernel(const __grid_constant__ Maps maps,        // of x, prev1, left0
                const __nv_bfloat16* __restrict__ w,      // (3, 3, C, C) HWIO
                const __nv_bfloat16* __restrict__ bias,   // (C,)
                int N, int act, int images, int tiles_x, int tiles)
{
    using S = Shape<C>;
    extern __shared__ __align__(1024) unsigned char smem[];
    const unsigned wsm = (smem_u32(smem) + 1023) & ~1023u;
    const unsigned halo = wsm + S::W_BYTES;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int nh = blockIdx.x % S::NH;  // this block's 64 output channels
    const int group = gridDim.x / S::NH;
    const int first = blockIdx.x / S::NH;
    const int stages = S::KCH * ((tiles - first + group - 1) / group);
    const unsigned full0 = halo + (S::NBUF - 1) * S::BUF + S::END;
    if (tid == 0) {
        for (int b = 0; b < S::NBUF; ++b) mbar_init(full0 + 8 * b, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }

    // resident weights: row (tap, ci) holds this block's 64 output
    // channels, 128 bytes, 16-byte chunk v at v ^ (row % 8); the proxy
    // fence makes the copies visible to wgmma
    for (int i = tid; i < 9 * C * 8; i += THREADS) {
        const int row = i / 8;
        const int v = i % 8;
        cp_async16(wsm + row * ROW + ((v ^ (row & 7)) << 4), w + (size_t)row * C + nh * NB + v * 8);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    if (tid >= CONSUMERS) {
        // registers go to the consumers: 2 x 128 x 232 + 128 x 40 <= 65,536
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::);
        // The producer: stage s (input channels [kc*64, kc*64+64) of its
        // tile's halo) into buffer s % NBUF once the consumers are done
        // with stage s-NBUF, by TMA boxes from the frames the channel
        // ranges name, at (x0-1, y0-1): the conv's zero padding is TMA's
        // zero fill.
        // Before a buffer is reloaded, the tile its last occupant finished
        // (outputs staged there by the consumers) goes out by TMA store.
        auto store = [&](int s) {
            if (s % S::KCH != S::KCH - 1) return;
            const Tile t = tile_at<C>(first + (s / S::KCH) * group, N, images, tiles_x);
            tma_store(maps.out, halo + (s % S::NBUF) * S::BUF, nh * NB, t.x0, t.y0, t.j * N + t.n);
        };
        for (int s = 0; s < stages + S::NBUF; ++s) {
            if (s >= S::NBUF) bar_sync<THREADS>(EMPTY + s % S::NBUF);
            if (tid != CONSUMERS) continue;
            if (s >= S::NBUF) store(s - S::NBUF);
            if (s >= stages) continue;
            const Tile t = tile_at<C>(first + (s / S::KCH) * group, N, images, tiles_x);
            const int kc = s % S::KCH;
            const unsigned buf = halo + (s % S::NBUF) * S::BUF;
            const unsigned mb = full0 + (s % S::NBUF) * 8;
            const int x0 = t.x0 - 1, y0 = t.y0 - 1;
            const int img = t.j * N + t.n;  // frame j; frame j-k is img - k*N
            mbar_expect(mb, (kc == 0 ? S::FIRST_BYTES : 0) + (kc == S::KCH - 1 ? S::LAST_BYTES : 0));
            if (kc == 0) {
                tma_load(buf + S::F, maps.xF, 0, x0, y0, img, mb);
                if (t.j >= 2)
                    tma_load(buf + S::M, maps.xF, S::FOLD, x0, y0, img - 2 * N, mb);
                else if (t.j == 1)
                    tma_load(buf + S::M, maps.pF, S::FOLD, x0, y0, t.n, mb);
                else
                    tma_load(buf + S::M, maps.lF, 0, x0, y0, t.n, mb);
                if (t.j >= 1)
                    tma_load(buf + S::RA, maps.xRA, 2 * S::FOLD, x0, y0, img - N, mb);
                else
                    tma_load(buf + S::RA, maps.pRA, 2 * S::FOLD, x0, y0, t.n, mb);
            }
            if (kc == S::KCH - 1) {
                if (t.j >= 1)
                    tma_load(buf + S::RB, maps.xRB, C - S::RB_BOX, x0, y0, img - N, mb);
                else
                    tma_load(buf + S::RB, maps.pRB, C - S::RB_BOX, x0, y0, t.n, mb);
            }
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
    int a_p[S::MT];  // this lane's halo pixel in each of its rows at tap (0, 0)
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt) {
        const int m = (wg * S::MT + mt) * 4 + wi;  // m16 tile of the output tile
        a_p[mt] = m * S::HW + a_px;
    }

    float acc[S::MT][32];
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[mt][e] = 0.0f;

    for (int s = 0; s < stages; ++s) {
        // each warpgroup waits for a stage on its own
        mbar_wait(full0 + (s % S::NBUF) * 8, (s / S::NBUF) & 1);

        const unsigned buf = halo + (s % S::NBUF) * S::BUF;
        const int kc = s % S::KCH;
        // 36 k16 steps (9 taps x 4 channel blocks).  A goes through SETS
        // register sets: once step k-1's wgmmas are done, A of step
        // k+SETS-1 loads into their set while step k's run.
        constexpr int STEPS = 9 * KC / 16;
        constexpr int SETS = S::A_SETS;
        uint32_t a[SETS][S::MT][4];
        auto load_a = [&](int k, uint32_t (&dst)[S::MT][4]) {
            const int tap = k / 4;
#pragma unroll
            for (int mt = 0; mt < S::MT; ++mt)
                ldsm_x4(a_addr<C>(buf, kc, a_p[mt] + (tap / 3) * S::HW + tap % 3, (k % 4) * 2 + a_hi), dst[mt]);
        };
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
            for (int e = 0; e < 32; ++e) fence_operand(acc[mt][e]);
#pragma unroll
        for (int k = 0; k < SETS - 1; ++k) load_a(k, a[k]);
#pragma unroll
        for (int k = 0; k < STEPS; ++k) {
            const unsigned wt = wsm + ((k / 4) * C + kc * KC + (k % 4) * 16) * ROW;
            wgmma_fence();
#pragma unroll
            for (int mt = 0; mt < S::MT; ++mt) wgmma_64x64x16(acc[mt], a[k % SETS][mt], b_desc(wt));
            wgmma_commit();
            wgmma_wait<1>();  // step k-1 is done with its register set
            if (k + SETS - 1 < STEPS) load_a(k + SETS - 1, a[(k + SETS - 1) % SETS]);
        }
        // the last ldmatrix of the stage is done: hand the buffer back
        if (kc != S::KCH - 1) bar_arrive<THREADS>(EMPTY + s % S::NBUF);
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
            for (int e = 0; e < 32; ++e) fence_operand(acc[mt][e]);
        if (kc != S::KCH - 1) continue;

        // epilogue: accumulator 4jn+e is (pixel g + 8*(e/2), channel
        // 8jn + 2q + e%2) -> bias, act, bf16 into the stage's buffer once
        // both warpgroups are done reading it: output pixel p of the tile
        // (row-major) at p*128 bytes, chunk jn at jn ^ (p % 8), the TMA
        // store's 128-byte swizzle; the producer stores it.
        bar_sync<CONSUMERS>(CONS);
        const int q = lane & 3;
        const int g = lane >> 2;
        float2 bv[8];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
            bv[jn] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + nh * NB + jn * 8 + 2 * q));
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt) {
            const int m = (wg * S::MT + mt) * 4 + wi;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int p = m * S::TW + g + 8 * half;  // p % 8 == g
#pragma unroll
                for (int jn = 0; jn < 8; ++jn) {
                    float v0 = acc[mt][4 * jn + 2 * half] + bv[jn].x;
                    float v1 = acc[mt][4 * jn + 2 * half + 1] + bv[jn].y;
                    if (act >= 1) {
                        v0 = fmaxf(v0, 0.0f);
                        v1 = fmaxf(v1, 0.0f);
                    }
                    if (act == 2) {
                        v0 = fminf(v0, 6.0f);
                        v1 = fminf(v1, 6.0f);
                    }
                    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(buf + p * ROW + ((jn ^ g) << 4) + q * 4),
                                 "r"(pack_bf16(v0, v1)) : "memory");
                }
            }
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[mt][e] = 0.0f;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the writes, for the TMA store
        bar_arrive<THREADS>(EMPTY + s % S::NBUF);
    }
}

// The persistent grid: tiles of the whole chunk and blocks to launch,
// NH per tile at the same time, never more blocks than SMs or work.
template <int C>
cudaError_t schedule(int T, int N, int H, int W, int* tiles_x, int* tiles, int* blocks)
{
    using S = Shape<C>;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    *tiles_x = (W + S::TW - 1) / S::TW;
    *tiles = T * N * *tiles_x * ((H + S::TH - 1) / S::TH);
    const int per_half = sms / S::NH < *tiles ? sms / S::NH : *tiles;
    *blocks = S::NH * (per_half > 1 ? per_half : 1);
    return cudaSuccess;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 tensor of `images` x H x W pixels of `ch` channels as a 4-d map
// (channel, x, y, image) whose boxes are box_ch x box_w x box_h x 1, with
// the swizzle of a box_ch * 2-byte row (none for 16 bytes).
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int ch, int W, int H, int images, int box_ch,
            int box_w, int box_h)
{
    const cuuint64_t dims[4] = {(cuuint64_t)ch, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)images};
    const cuuint64_t strides[3] = {(cuuint64_t)ch * 2, (cuuint64_t)ch * 2 * W, (cuuint64_t)ch * 2 * W * H};
    const cuuint32_t box[4] = {(cuuint32_t)box_ch, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swizzle = box_ch * 2 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : box_ch * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                       : box_ch * 2 == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                          : CU_TENSOR_MAP_SWIZZLE_NONE;
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C>
cudaError_t launch(const void* x, const void* prev1, const void* left0, const void* w,
                   const void* b, void* out, int T, int N, int H, int W, int act,
                   cudaStream_t stream)
{
    using S = Shape<C>;
    // the driver's tensor-map encoder, found once through the runtime
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
    const int hw = S::HW, hh = S::HH;
    if (!encode(fn, &maps.xF, x, C, W, H, T * N, S::F_BOX, hw, hh) ||
        !encode(fn, &maps.xRA, x, C, W, H, T * N, S::RA_BOX, hw, hh) ||
        !encode(fn, &maps.xRB, x, C, W, H, T * N, S::RB_BOX, hw, hh) ||
        !encode(fn, &maps.pF, prev1, C, W, H, N, S::F_BOX, hw, hh) ||
        !encode(fn, &maps.pRA, prev1, C, W, H, N, S::RA_BOX, hw, hh) ||
        !encode(fn, &maps.pRB, prev1, C, W, H, N, S::RB_BOX, hw, hh) ||
        !encode(fn, &maps.lF, left0, S::FOLD, W, H, N, S::F_BOX, hw, hh) ||
        !encode(fn, &maps.out, out, C, W, H, T * N, NB, S::TW, S::TH))
        return cudaErrorNotSupported;
    // above 48 KB a block needs the opt-in, once per device and kernel: the
    // attribute belongs to the current device's context
    constexpr int MAX_DEVICES = 64;
    static bool configured[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES || !configured[dev]) {
        err = cudaFuncSetAttribute(tsm_conv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
        if (err != cudaSuccess) return err;
        if (dev < MAX_DEVICES) configured[dev] = true;
    }
    int tiles_x, tiles, blocks;
    err = schedule<C>(T, N, H, W, &tiles_x, &tiles, &blocks);
    if (err != cudaSuccess) return err;
    tsm_conv_kernel<C><<<blocks, THREADS, S::SMEM, stream>>>(
        maps, static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(b), N, act,
        T * N, tiles_x, tiles);
    return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  act: 0 none, 1 relu, 2 relu6.  Returns the
// cudaError_t of the launch (0 on success); an unsupported C returns
// cudaErrorInvalidValue, a tensor map the driver refuses
// cudaErrorNotSupported.
extern "C" int tsm_conv_bf16(const void* x, const void* prev1, const void* left0,
                             const void* w, const void* b, void* out, int T, int N,
                             int H, int W, int C, int act, void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (T < 1 || N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    switch (C) {
        case 64: return (int)launch<64>(x, prev1, left0, w, b, out, T, N, H, W, act, s);
        case 128: return (int)launch<128>(x, prev1, left0, w, b, out, T, N, H, W, act, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The grid tsm_conv_bf16 launches for a shape on the current device:
// spatial tiles of the chunk (each computed by C/64 blocks, one per 64
// output channels) and persistent blocks.  Same return codes.
extern "C" int tsm_conv_schedule(int T, int N, int H, int W, int C, int* tiles, int* blocks)
{
    if (T < 1 || N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    int tiles_x;
    switch (C) {
        case 64: return (int)schedule<64>(T, N, H, W, &tiles_x, tiles, blocks);
        case 128: return (int)schedule<128>(T, N, H, W, &tiles_x, tiles, blocks);
        default: return (int)cudaErrorInvalidValue;
    }
}
