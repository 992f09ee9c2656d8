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
// Design.  The TPU kernel exists to build the channel mix on chip instead
// of writing the mixed tensor to HBM and reading it back; this kernel
// keeps that point and nothing of the TPU layout (no lane packing, no
// pair-shift weight blocks, no DMA ring).  Each block computes a TH x 16
// pixel tile of one frame for all C output channels as an implicit GEMM
// (M = 16*TH pixels, N = C, K = 9*C) with 8 warps:
//   1. load the (TH+2) x 18 input halo into shared memory, taking each
//      8-channel vector from the frame its channel range names (three
//      base pointers), zero outside the image (the conv's zero padding);
//   2. for each of the 9 taps, stage that tap's C x C weights in shared
//      memory (all warps share them), then run bf16 tensor-core MMAs
//      (wmma 16x16x16, f32 accumulators): each warp owns 2 output rows
//      (two 16-pixel M tiles) x 64 output channels (four N tiles), so a
//      B fragment feeds two MMAs and an A fragment four;
//   3. epilogue: accumulators staged through shared memory, bias + relu
//      or relu6 in f32, one 16-byte bf16 store per lane.
// C=64: 8 warps stacked over 16 rows; C=128: 4 x 2 warps over 8 rows.
// A first version with an 8x16 tile and B read from global memory ran
// 3x slower.  wgmma, TMA, cp.async double buffering of the weights and a
// persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TW = 16;  // output columns per block (one 16-pixel M tile)
constexpr int HW = TW + 2;
constexpr int THREADS = 256;
constexpr int MT = 2;   // M tiles (output rows) per warp
constexpr int NT = 4;   // N tiles (16 output channels each) per warp

template <int C>
struct Shape {
    static constexpr int FOLD = C / 8;
    static constexpr int WN = C / (16 * NT);  // warps across output channels
    static constexpr int WM = 8 / WN;         // warps across rows
    static constexpr int TH = WM * MT;        // output rows per block
    static constexpr int HH = TH + 2;
    // shared-memory strides in elements: halo pixels stay 32-byte aligned
    // (wmma's pointer rule) and neighbouring pixels / weight rows start on
    // other banks
    static constexpr int PIX = C + 16;
    static constexpr int WLD = C + 8;
    static constexpr int HALO_BYTES = HH * HW * PIX * 2;
    static constexpr int SMEM = HALO_BYTES + C * WLD * 2;
    static constexpr int KB = C / 16;  // input-channel chunks per tap
    static_assert(FOLD % 8 == 0, "channel ranges must be whole 8-channel vectors");
    static_assert(WM * WN == 8, "8 warps tile the block");
    static_assert(HALO_BYTES >= 8 * 16 * 16 * 4, "the epilogue stage fits in the halo");
};

template <int C>
__global__ void __launch_bounds__(THREADS)
tsm_conv_kernel(const __nv_bfloat16* __restrict__ x,      // (T, N, H, W, C)
                const __nv_bfloat16* __restrict__ prev1,  // (N, H, W, C)
                const __nv_bfloat16* __restrict__ left0,  // (N, H, W, C/8)
                const __nv_bfloat16* __restrict__ w,      // (3, 3, C, C) HWIO
                const __nv_bfloat16* __restrict__ bias,   // (C,)
                __nv_bfloat16* __restrict__ out,          // (T, N, H, W, C)
                int N, int H, int W, int act)
{
    using S = Shape<C>;
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + S::HALO_BYTES);

    const int j = blockIdx.z / N;
    const int n = blockIdx.z % N;
    const int y0 = blockIdx.y * S::TH;
    const int x0 = blockIdx.x * TW;
    const size_t plane = (size_t)H * W;

    // the three sources of the channel mix
    const __nv_bfloat16* fut = x + ((size_t)j * N + n) * plane * C;
    const __nv_bfloat16* mid;  // frame j-2, channels [fold, 2fold)
    int mid_pix, mid_off;      // its pixel stride and channel offset
    if (j >= 2) {
        mid = x + ((size_t)(j - 2) * N + n) * plane * C;
        mid_pix = C;
        mid_off = 0;
    } else if (j == 1) {
        mid = prev1 + (size_t)n * plane * C;
        mid_pix = C;
        mid_off = 0;
    } else {
        mid = left0 + (size_t)n * plane * S::FOLD;
        mid_pix = S::FOLD;
        mid_off = S::FOLD;
    }
    const __nv_bfloat16* rest = j >= 1 ? x + ((size_t)(j - 1) * N + n) * plane * C
                                       : prev1 + (size_t)n * plane * C;

    // 1. halo load, one 16-byte vector (8 channels) per step
    constexpr int VEC = C / 8;
    for (int i = threadIdx.x; i < S::HH * HW * VEC; i += THREADS) {
        const int v = i % VEC;
        const int p = i / VEC;
        const int hx = p % HW;
        const int hy = p / HW;
        const int gy = y0 - 1 + hy;
        const int gx = x0 - 1 + hx;
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
        *reinterpret_cast<uint4*>(halo + (hy * HW + hx) * S::PIX + v * 8) = val;
    }

    // 2. implicit GEMM on the tensor cores, one tap at a time
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int wm = warp / S::WN;
    const int wn = warp % S::WN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][NT];
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NT; ++b) wmma::fill_fragment(acc[a][b], 0.0f);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[MT];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
    for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3;
        const int dx = tap % 3;
        __syncthreads();  // the halo is in; the last tap's weights are used up
        const __nv_bfloat16* wtap = w + (size_t)tap * C * C;
        for (int i = threadIdx.x; i < C * C / 8; i += THREADS) {
            const int r = i / (C / 8);
            const int v = i % (C / 8);
            *reinterpret_cast<uint4*>(wsm + r * S::WLD + v * 8) =
                __ldg(reinterpret_cast<const uint4*>(wtap + r * C + v * 8));
        }
        __syncthreads();
#pragma unroll 2
        for (int kb = 0; kb < S::KB; ++kb) {
#pragma unroll
            for (int a = 0; a < MT; ++a)
                wmma::load_matrix_sync(
                    fa[a], halo + ((wm * MT + a + dy) * HW + dx) * S::PIX + kb * 16, S::PIX);
#pragma unroll
            for (int b = 0; b < NT; ++b) {
                wmma::load_matrix_sync(fb, wsm + kb * 16 * S::WLD + (wn * NT + b) * 16, S::WLD);
#pragma unroll
                for (int a = 0; a < MT; ++a) wmma::mma_sync(acc[a][b], fa[a], fb, acc[a][b]);
            }
        }
    }

    // 3. epilogue through a per-warp stage in the (now free) halo; lane ->
    // (pixel lane/2, 8-channel half lane%2)
    __syncthreads();
    float* st = reinterpret_cast<float*>(smem) + warp * 256;
    const int px = lane / 2;
    const int hi = lane % 2;
    const int ox = x0 + px;
#pragma unroll
    for (int a = 0; a < MT; ++a) {
        const int oy = y0 + wm * MT + a;
        __nv_bfloat16* orow = out + (((size_t)j * N + n) * plane + (size_t)oy * W + ox) * C;
#pragma unroll
        for (int b = 0; b < NT; ++b) {
            wmma::store_matrix_sync(st, acc[a][b], 16, wmma::mem_row_major);
            __syncwarp();
            if (oy < H && ox < W) {
                const int c0 = (wn * NT + b) * 16 + hi * 8;
                __align__(16) __nv_bfloat16 v[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    float y = st[px * 16 + hi * 8 + e] + __bfloat162float(bias[c0 + e]);
                    if (act >= 1) y = fmaxf(y, 0.0f);
                    if (act == 2) y = fminf(y, 6.0f);
                    v[e] = __float2bfloat16(y);
                }
                *reinterpret_cast<uint4*>(orow + c0) = *reinterpret_cast<const uint4*>(v);
            }
            __syncwarp();
        }
    }
}

template <int C>
cudaError_t launch(const void* x, const void* prev1, const void* left0, const void* w,
                   const void* b, void* out, int T, int N, int H, int W, int act,
                   cudaStream_t stream)
{
    using S = Shape<C>;
    // above 48 KB a block needs the opt-in, once per process and kernel
    static bool configured = false;
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            tsm_conv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    dim3 grid((W + TW - 1) / TW, (H + S::TH - 1) / S::TH, T * N);
    tsm_conv_kernel<C><<<grid, THREADS, S::SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(prev1),
        static_cast<const __nv_bfloat16*>(left0), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out), N, H, W, act);
    return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  act: 0 none, 1 relu, 2 relu6.  Returns the
// cudaError_t of the launch (0 on success); an unsupported C returns
// cudaErrorInvalidValue.
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
