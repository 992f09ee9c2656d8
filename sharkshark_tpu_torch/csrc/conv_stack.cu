// A stack of L x [3x3 SAME conv + bias + PReLU] layers at 64 channels in
// one kernel, for NVIDIA Hopper (sm_90a), bf16 in and out, f32
// accumulate: SRVGG's body.
//
// Replaces: experiments/conv_stack.py::fused_conv_stack (the Pallas TPU
// kernel, which has no bias).  Same function as the port's plain version,
// sharkshark_tpu_torch/ops/conv_stack.py::fused_conv_stack_plain: each
// layer accumulates in f32, adds its bias, applies PReLU with per-channel
// alpha, and rounds once to bf16.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at SRVGG's
// shape (4, 720, 1280, 64): one layer is 2*9*64*64*N*H*W = 2.72e11 FLOP
// -> 0.275 ms, and x read + out written once is 0.94 GB -> 0.282 ms, so L
// layers are bounded by max(0.275 L, 0.282) ms.  Run one launch per layer,
// the body is bytes-bound; L >= 2 makes it operations-bound.  (chip_smoke.py
// recomputes the bound from the tensors it launches on.)
//
// Design.  One block computes a TH x (32 - 2L) output tile of one image
// through all L layers.  It loads the input tile with an L-pixel halo
// into shared memory (zero outside the image) and runs layer l over the
// region that layers l+1.. still need, which shrinks by one pixel a side
// per layer (the TPU kernel's shrinking valid region).  Two buffers take
// turns as a layer's input and output; only the last layer writes to
// device memory, so activation traffic falls L-fold.
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
// TH is the most rows that fit two buffers in shared memory: 16 for
// L <= 2, 14 for L = 3, 12 for L = 4 (L_MAX).  The halo recompute costs
// 1.2x (L=1) to 1.7x (L=4) the useful MACs; wgmma, TMA and a wider tile
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int C = 64;
constexpr int L_MAX = 4;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NT = C / 16;      // a work item is one M tile x all 64 channels
constexpr int IT = 4;           // work items a warp holds at once
constexpr int WB = 32;          // buffer row width, pixels
constexpr int PIX = C + 16;     // pixel stride in elements (32-byte aligned for wmma)
constexpr int WLD = C + 8;
constexpr int WSLOTS = 3;       // weight taps in flight: the one in use and two loading
constexpr int WTAP = C * WLD;   // elements of one staged tap

__host__ __device__ constexpr int align128(int b) { return (b + 127) / 128 * 128; }

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
    s.off_b = align128(s.pix_a * PIX * 2);
    s.off_w = s.off_b + align128(s.pix_b * PIX * 2);
    s.off_st = s.off_w + align128(WSLOTS * WTAP * 2);
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

}  // namespace

// C interface for ctypes.  Returns the cudaError_t of the launch (0 on
// success); L outside [1, L_MAX] or an empty shape returns
// cudaErrorInvalidValue.
extern "C" int conv_stack_bf16(const void* x, const void* w, const void* bias, const void* alpha,
                               void* out, int N, int H, int W, int L, void* stream)
{
    if (L < 1 || L > L_MAX || N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    const Layout s = layout(L);
    // above 48 KB a block needs the opt-in; raise it to the largest layout
    static int configured = 0;
    if (configured < s.smem) {
        int most = 0;
        for (int l = 1; l <= L_MAX; ++l) most = layout(l).smem > most ? layout(l).smem : most;
        cudaError_t err = cudaFuncSetAttribute(conv_stack_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (err != cudaSuccess) return (int)err;
        configured = most;
    }
    dim3 grid((W + s.tw - 1) / s.tw, (H + s.th - 1) / s.th, N);
    conv_stack_kernel<<<grid, THREADS, s.smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(alpha),
        static_cast<__nv_bfloat16*>(out), L, H, W);
    return (int)cudaGetLastError();
}
