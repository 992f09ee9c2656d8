// BSVD mem block: two temporal-shift 3x3 convs (c1 then c2) over a
// T-frame chunk in one kernel, for NVIDIA Hopper (sm_90a), bf16 in and
// out, f32 accumulate.  c1's output y1 stays in shared memory.
//
// Replaces: sharkshark_tpu/ops/pallas/tsm_conv.py::tsm_conv_pair (the
// Pallas TPU kernel).  Same function as the port's plain version,
// sharkshark_tpu_torch/ops/tsm_conv.py::tsm_conv_pair_plain.
//
// What it computes.  x holds frames [a, a+T) of the block's input; c1's
// carry is prev1_x = x_{a-1} and left0_x = x_{a-2}[..., fold:2fold], c2's
// carry is prev1_y = y1_{a-1} and left0_y = y1_{a-2}[..., fold:2fold]
// (fold = C/8).  With mix(f)_j = [f_j[:fold] | f_{j-2}[fold:2fold] |
// f_{j-1}[2fold:]],
//   y1_j = act(conv3x3_zeropad(mix(x)_j)  * w1 + b1),
//   y2_j = act(conv3x3_zeropad(mix(y1)_j) * w2 + b2),
// and the kernel writes y2 (T, N, H, W, C) and y1 of the chunk's last two
// frames (2, N, H, W, C), which is c2's carry for the next chunk.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at the warm
// chunk's shapes (T=4, N=1): 2 convs x 2*9*C*C*H*W*T = 1.36e11 FLOP ->
// 0.137 ms at C=64, 360x640 and at C=128, 180x320; x, the carries, y2 and
// y1_last2 move 0.18 / 0.09 GB -> 0.055 / 0.027 ms.  Operations-bound.
// (chip_smoke.py recomputes both from the tensors it launches on.)
//
// Design.  A block owns one TH x 28 output tile of all T frames and walks
// t in order (design (a) of the two: nothing is recomputed across frames,
// and y1 never leaves the SM).  It keeps, in shared memory, y1 of frame
// j-1 (channels [fold, C), with a 1-pixel halo) and y1 of frame j-2
// (channels [fold, 2fold)); at j = 0, 1 they come from c2's carry.  Per
// frame:
//   1. load the mixed x tile with a 2-pixel halo (zero outside the image);
//   2. c1 over the (TH+2) x 30 region conv2 needs, as an implicit GEMM on
//      the tensor cores (wmma 16x16x16, f32 accumulators);
//   3. epilogue: bias + act in f32, bf16; positions outside the image are
//      written as ZERO, not act(b1): c2 pads with zeros (the TPU kernel
//      zeroes the same halo rows); y1's [0, fold) channels go straight
//      into the mixed buffer of c2, the rest into the frame-(j-1) slot;
//      for the last two frames the interior is also written out (carry);
//   4. fill c2's mixed buffer from the two older y1 slots, rotate them;
//   5. c2 over the TH x 28 tile, epilogue to y2.
// The implicit GEMM runs over the tile's pixels in row-major order at the
// buffer's row width WB = 32: output pixel p reads input pixel
// p + dy*WB + dx for tap (dy, dx), so every 16-pixel M tile is one
// strided wmma load per tap whatever the rows; the 2-4 columns past the
// valid width of each row are computed and dropped.  Weights are staged
// one tap (C x C) at a time: a whole conv's weights (295 KB at C=128)
// exceed shared memory.  C=64 runs TH=8 rows (166 KB of shared memory),
// C=128 TH=4 (216 KB).  The halo recompute (c1 over (TH+2) rows for TH)
// and the serial t loop are the price of keeping y1 on chip; wgmma, TMA
// and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NT = 4;   // N tiles (16 output channels each) per work item

__host__ __device__ constexpr int align128(int b) { return (b + 127) / 128 * 128; }

template <int C>
struct Shape {
    static constexpr int FOLD = C / 8;
    static constexpr int TH = C == 64 ? 8 : 4;   // output rows per block
    static constexpr int WB = 32;                // buffer row width, pixels
    static constexpr int TW = WB - 4;            // output columns per block
    static constexpr int PIX = C + 16;           // mixed-buffer pixel stride (32-byte aligned for wmma)
    static constexpr int YC = C - FOLD;          // y1 channels kept for the next frames
    static constexpr int YS = YC + 8;            // their pixel stride
    static constexpr int WLD = C + 8;
    static constexpr int NG = C / (16 * NT);     // 64-channel groups
    static constexpr int M1 = (TH + 2) * WB / 16;  // c1's 16-pixel M tiles
    static constexpr int M2 = TH * WB / 16;        // c2's
    static constexpr int IT1 = (M1 * NG + WARPS - 1) / WARPS;
    static constexpr int IT2 = (M2 * NG + WARPS - 1) / WARPS;
    static constexpr int XPIX = (TH + 4) * WB + 2;  // + 2: the last tap's overrun
    static constexpr int YPIX = (TH + 2) * WB;
    static constexpr int OFF_Y0 = align128(XPIX * PIX * 2);
    static constexpr int OFF_Y1 = OFF_Y0 + align128(YPIX * YS * 2);
    static constexpr int OFF_S = OFF_Y1 + align128(YPIX * YS * 2);
    static constexpr int OFF_W = OFF_S + align128(YPIX * FOLD * 2);
    static constexpr int OFF_ST = OFF_W + align128(C * WLD * 2);
    static constexpr int SMEM = OFF_ST + WARPS * 256 * 4;
    static_assert(FOLD % 8 == 0, "channel ranges must be whole 8-channel vectors");
    static_assert((TH * WB) % 16 == 0, "whole M tiles");
    static_assert(SMEM <= 232448, "fits one block's shared memory");
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// One 3x3 conv over `nmt` 16-pixel M tiles of `in` (pixel stride PIX,
// row width WB), all C output channels; work item i = (M tile i / NG,
// channel group i % NG) goes to warp i % WARPS.
template <int C, int IT>
__device__ __forceinline__ void conv_gemm(const __nv_bfloat16* in, int nmt,
                                          const __nv_bfloat16* __restrict__ w,
                                          __nv_bfloat16* wsm, AccFrag (&acc)[IT][NT])
{
    using S = Shape<C>;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int it = 0; it < IT; ++it)
#pragma unroll
        for (int b = 0; b < NT; ++b) wmma::fill_fragment(acc[it][b], 0.0f);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
    for (int tap = 0; tap < 9; ++tap) {
        const int shift = (tap / 3) * S::WB + tap % 3;
        __syncthreads();  // the input is in; the last tap's weights are used up
        const __nv_bfloat16* wtap = w + (size_t)tap * C * C;
        for (int i = threadIdx.x; i < C * C / 8; i += THREADS) {
            const int r = i / (C / 8);
            const int v = i % (C / 8);
            *reinterpret_cast<uint4*>(wsm + r * S::WLD + v * 8) =
                __ldg(reinterpret_cast<const uint4*>(wtap + r * C + v * 8));
        }
        __syncthreads();
#pragma unroll
        for (int it = 0; it < IT; ++it) {
            const int item = warp + it * WARPS;
            if (item < nmt * S::NG) {
                const int mt = item / S::NG;
                const int ng = item % S::NG;
#pragma unroll 2
                for (int kb = 0; kb < C / 16; ++kb) {
                    wmma::load_matrix_sync(fa, in + (mt * 16 + shift) * S::PIX + kb * 16, S::PIX);
#pragma unroll
                    for (int b = 0; b < NT; ++b) {
                        wmma::load_matrix_sync(fb, wsm + kb * 16 * S::WLD + (ng * NT + b) * 16, S::WLD);
                        wmma::mma_sync(acc[it][b], fa, fb, acc[it][b]);
                    }
                }
            }
        }
    }
}

// Hands each 8-channel vector of the accumulators to f(p, c0, v[8]) with
// bias + act applied: p = linear pixel of the GEMM, c0 = first channel.
template <int C, int IT, class F>
__device__ __forceinline__ void epilogue(AccFrag (&acc)[IT][NT], int nmt, float* stage,
                                         const __nv_bfloat16* __restrict__ bias, int act, F f)
{
    using S = Shape<C>;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int px = lane / 2;
    const int hi = lane % 2;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
        const int item = warp + it * WARPS;
        if (item >= nmt * S::NG) continue;
        const int mt = item / S::NG;
        const int ng = item % S::NG;
#pragma unroll
        for (int b = 0; b < NT; ++b) {
            wmma::store_matrix_sync(stage, acc[it][b], 16, wmma::mem_row_major);
            __syncwarp();
            const int c0 = (ng * NT + b) * 16 + hi * 8;
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                float y = stage[px * 16 + hi * 8 + e] + __bfloat162float(bias[c0 + e]);
                if (act >= 1) y = fmaxf(y, 0.0f);
                if (act == 2) y = fminf(y, 6.0f);
                v[e] = y;
            }
            f(mt * 16 + px, c0, v);
            __syncwarp();
        }
    }
}

__device__ __forceinline__ uint4 pack8(const float* v)
{
    __align__(16) __nv_bfloat16 h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(v[e]);
    return *reinterpret_cast<const uint4*>(h);
}

template <int C>
__global__ void __launch_bounds__(THREADS)
tsm_conv_pair_kernel(const __nv_bfloat16* __restrict__ x,        // (T, N, H, W, C)
                     const __nv_bfloat16* __restrict__ prev1_x,  // (N, H, W, C)
                     const __nv_bfloat16* __restrict__ left0_x,  // (N, H, W, C/8)
                     const __nv_bfloat16* __restrict__ prev1_y,  // (N, H, W, C)
                     const __nv_bfloat16* __restrict__ left0_y,  // (N, H, W, C/8)
                     const __nv_bfloat16* __restrict__ w1,       // (3, 3, C, C) HWIO
                     const __nv_bfloat16* __restrict__ b1,       // (C,)
                     const __nv_bfloat16* __restrict__ w2,
                     const __nv_bfloat16* __restrict__ b2,
                     __nv_bfloat16* __restrict__ out,            // (T, N, H, W, C)
                     __nv_bfloat16* __restrict__ carry,          // (2, N, H, W, C)
                     int T, int N, int H, int W, int act)
{
    using S = Shape<C>;
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* mixed = reinterpret_cast<__nv_bfloat16*>(smem);  // x mix, then c2's mix
    __nv_bfloat16* yprev = reinterpret_cast<__nv_bfloat16*>(smem + S::OFF_Y0);
    __nv_bfloat16* ynew = reinterpret_cast<__nv_bfloat16*>(smem + S::OFF_Y1);
    __nv_bfloat16* slice2 = reinterpret_cast<__nv_bfloat16*>(smem + S::OFF_S);
    __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + S::OFF_W);
    float* stage = reinterpret_cast<float*>(smem + S::OFF_ST) + (threadIdx.x / 32) * 256;

    const int n = blockIdx.z;
    const int y0 = blockIdx.y * S::TH;
    const int x0 = blockIdx.x * S::TW;
    const size_t plane = (size_t)H * W;
    constexpr int VEC = C / 8;
    constexpr int FV = S::FOLD / 8;

    // the last tap's overrun pixels, and c2's carry into the y1 slots:
    // slot (r, c) <-> image (y0 - 1 + r, x0 - 1 + c), zero outside
    for (int i = threadIdx.x; i < 2 * VEC; i += THREADS)
        *reinterpret_cast<uint4*>(mixed + ((S::XPIX - 2) + i / VEC) * S::PIX + (i % VEC) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < S::YPIX * VEC; i += THREADS) {
        const int v = i % VEC;
        const int p = i / VEC;
        const int gy = y0 - 1 + p / S::WB;
        const int gx = x0 - 1 + p % S::WB;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const size_t pix = (size_t)n * plane + (size_t)gy * W + gx;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (v < FV) {
            if (inside) val = __ldg(reinterpret_cast<const uint4*>(left0_y + pix * S::FOLD + v * 8));
            *reinterpret_cast<uint4*>(slice2 + p * S::FOLD + v * 8) = val;
        } else {
            if (inside) val = __ldg(reinterpret_cast<const uint4*>(prev1_y + pix * C + v * 8));
            *reinterpret_cast<uint4*>(yprev + p * S::YS + (v - FV) * 8) = val;
        }
    }

    for (int j = 0; j < T; ++j) {
        // 1. the mixed x tile, 2-pixel halo: (r, c) <-> (y0 - 2 + r, x0 - 2 + c)
        const __nv_bfloat16* fut = x + ((size_t)j * N + n) * plane * C;
        const __nv_bfloat16* mid;  // frame j-2, channels [fold, 2fold)
        int mid_pix, mid_off;
        if (j >= 2) {
            mid = x + ((size_t)(j - 2) * N + n) * plane * C;
            mid_pix = C;
            mid_off = 0;
        } else if (j == 1) {
            mid = prev1_x + (size_t)n * plane * C;
            mid_pix = C;
            mid_off = 0;
        } else {
            mid = left0_x + (size_t)n * plane * S::FOLD;
            mid_pix = S::FOLD;
            mid_off = S::FOLD;
        }
        const __nv_bfloat16* rest = j >= 1 ? x + ((size_t)(j - 1) * N + n) * plane * C
                                           : prev1_x + (size_t)n * plane * C;
        __syncthreads();  // the last frame's c2 is done with the mixed buffer
        for (int i = threadIdx.x; i < (S::TH + 4) * S::WB * VEC; i += THREADS) {
            const int v = i % VEC;
            const int p = i / VEC;
            const int gy = y0 - 2 + p / S::WB;
            const int gx = x0 - 2 + p % S::WB;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
                const size_t pix = (size_t)gy * W + gx;
                const int c = v * 8;
                const __nv_bfloat16* src;
                if (c < S::FOLD)
                    src = fut + pix * C + c;
                else if (c < 2 * S::FOLD)
                    src = mid + pix * mid_pix + (c - mid_off);
                else
                    src = rest + pix * C + c;
                val = __ldg(reinterpret_cast<const uint4*>(src));
            }
            *reinterpret_cast<uint4*>(mixed + p * S::PIX + v * 8) = val;
        }

        // 2-3. c1 over (TH + 2) rows: y1 pixel (r, c) <-> (y0 - 1 + r, x0 - 1 + c)
        {
            AccFrag acc[S::IT1][NT];
            conv_gemm<C, S::IT1>(mixed, S::M1, w1, wsm, acc);
            __syncthreads();  // every warp is done reading the x tile
            const int carry_k = j - (T - 2);
            epilogue<C, S::IT1>(acc, S::M1, stage, b1, act, [&](int p, int c0, float* v) {
                const int r = p / S::WB;
                const int c = p % S::WB;
                if (c >= S::TW + 2) return;
                const int gy = y0 - 1 + r;
                const int gx = x0 - 1 + c;
                const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
                if (!inside) {
#pragma unroll
                    for (int e = 0; e < 8; ++e) v[e] = 0.0f;
                }
                const uint4 packed = pack8(v);
                if (c0 < S::FOLD)
                    *reinterpret_cast<uint4*>(mixed + p * S::PIX + c0) = packed;
                else
                    *reinterpret_cast<uint4*>(ynew + p * S::YS + (c0 - S::FOLD)) = packed;
                if (carry_k >= 0 && inside && r >= 1 && r <= S::TH && c >= 1 && c <= S::TW)
                    *reinterpret_cast<uint4*>(
                        carry + (((size_t)carry_k * N + n) * plane + (size_t)gy * W + gx) * C + c0) = packed;
            });
        }
        __syncthreads();

        // 4. c2's mix: [fold, 2fold) from y1_{j-2}, [2fold, C) from y1_{j-1};
        // then y1_{j-1}'s [fold, 2fold) becomes the next frame's y1_{j-2}
        for (int i = threadIdx.x; i < S::YPIX * (VEC - FV); i += THREADS) {
            const int v = i % (VEC - FV);  // vector within [fold, C)
            const int p = i / (VEC - FV);
            uint4* dst = reinterpret_cast<uint4*>(mixed + p * S::PIX + S::FOLD + v * 8);
            const uint4 prev = *reinterpret_cast<const uint4*>(yprev + p * S::YS + v * 8);
            if (v < FV) {
                uint4* s2 = reinterpret_cast<uint4*>(slice2 + p * S::FOLD + v * 8);
                *dst = *s2;
                *s2 = prev;
            } else {
                *dst = prev;
            }
        }
        __nv_bfloat16* tmp = yprev;
        yprev = ynew;
        ynew = tmp;

        // 5. c2 over the TH-row tile: pixel (r, c) <-> (y0 + r, x0 + c)
        {
            AccFrag acc[S::IT2][NT];
            conv_gemm<C, S::IT2>(mixed, S::M2, w2, wsm, acc);
            __nv_bfloat16* oframe = out + ((size_t)j * N + n) * plane * C;
            epilogue<C, S::IT2>(acc, S::M2, stage, b2, act, [&](int p, int c0, float* v) {
                const int c = p % S::WB;
                const int gy = y0 + p / S::WB;
                const int gx = x0 + c;
                if (c < S::TW && gy < H && gx < W)
                    *reinterpret_cast<uint4*>(oframe + ((size_t)gy * W + gx) * C + c0) = pack8(v);
            });
        }
    }
}

template <int C>
cudaError_t launch(const void* x, const void* p1x, const void* l0x, const void* p1y,
                   const void* l0y, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, void* carry, int T, int N, int H, int W,
                   int act, cudaStream_t stream)
{
    using S = Shape<C>;
    // above 48 KB a block needs the opt-in, once per process and kernel
    static bool configured = false;
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            tsm_conv_pair_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    using B = __nv_bfloat16;
    dim3 grid((W + S::TW - 1) / S::TW, (H + S::TH - 1) / S::TH, N);
    tsm_conv_pair_kernel<C><<<grid, THREADS, S::SMEM, stream>>>(
        static_cast<const B*>(x), static_cast<const B*>(p1x), static_cast<const B*>(l0x),
        static_cast<const B*>(p1y), static_cast<const B*>(l0y), static_cast<const B*>(w1),
        static_cast<const B*>(b1), static_cast<const B*>(w2), static_cast<const B*>(b2),
        static_cast<B*>(out), static_cast<B*>(carry), T, N, H, W, act);
    return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  act: 0 none, 1 relu, 2 relu6.  Returns the
// cudaError_t of the launch (0 on success); T < 2 or an unsupported C
// returns cudaErrorInvalidValue.
extern "C" int tsm_conv_pair_bf16(const void* x, const void* prev1_x, const void* left0_x,
                                  const void* prev1_y, const void* left0_y, const void* w1,
                                  const void* b1, const void* w2, const void* b2, void* out,
                                  void* carry, int T, int N, int H, int W, int C, int act,
                                  void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (T < 2 || N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    switch (C) {
        case 64:
            return (int)launch<64>(x, prev1_x, left0_x, prev1_y, left0_y, w1, b1, w2, b2, out,
                                   carry, T, N, H, W, act, s);
        case 128:
            return (int)launch<128>(x, prev1_x, left0_x, prev1_y, left0_y, w1, b1, w2, b2, out,
                                    carry, T, N, H, W, act, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
