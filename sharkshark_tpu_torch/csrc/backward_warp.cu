// Bilinear backward warp of an NHWC image along a per-pixel flow, for
// NVIDIA Hopper (sm_90a): EGVSR's warp of the previous HR frame.
//
// Replaces: sharkshark_tpu/ops/pallas/warp_band.py::banded_backward_warp
// (the Pallas TPU kernel).  Same function as the port's plain version,
// sharkshark_tpu_torch/ops/warp.py::backward_warp_plain.
//
// What it computes.  out[n, v, u, :] = x sampled at (u + dx, v + dy),
// (dx, dy) = flow[n, v, u, :] in pixels, with grid_sample semantics
// (bilinear, align_corners=True, border clamp): the sample point is
// clamped to [0, W-1] x [0, H-1], and its four neighbours (the second
// one clamped too) are lerped in float32.  x is bf16 or float32 with
// C = 1..4 channels; the flow is bf16 or float32; out has x's dtype.
// Options:
//   s > 1:  out is space_to_depth(warp(x), s), (N, H/s, W/s, s*s*C) with
//           channel (dy*s + dx)*C + c: each thread writes its pixel to
//           the permuted address, so the relayout costs no extra pass;
//   skip:   a device bool; when set, out is x itself (in out's layout),
//           copied exactly.  EGVSR's scene-cut test sets it on the device,
//           so the host never waits for it.
//
// Bound on an H100 SXM (3.35 TB/s), at the EGVSR path's shape
// (1, 2880, 5120, 3), bf16 x and flow: x read once (88.5 MB), the flow
// read once (59.0 MB), out written once (88.5 MB) -> 236 MB -> 70 us,
// bytes-bound (about 15 flops per output value).  chip_smoke.py
// recomputes it from the tensors it launches on.
//
// Design.  The TPU kernel turns the gather into banded hat-matrix
// products, with per-tile window bases, edge padding, three window sizes
// and a gather fallback, because gathers are slow on a TPU.  On the card a
// gather is four loads, so none of that is ported: one thread per output
// pixel does four loads per channel and one lerp, exact for every flow.
// A block covers 64 columns x 4 rows, so that for s = 4 its rows are one
// s2d row and its writes land in one contiguous span.  Neighbouring
// threads read neighbouring flow pairs (coalesced) and, for a smooth flow,
// neighbouring source pixels.  Three-channel pixels are 6 bytes and not
// aligned, so x is read and out written one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 64;
constexpr int BY = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v)
{
    return __float2bfloat16(v);
}

__device__ __forceinline__ float2 load_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p)
{
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// a * (1 - t) + b * t, each step rounded as the plain version rounds it
// (no fused multiply-add)
__device__ __forceinline__ float lerp(float a, float b, float t)
{
    return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, t)), __fmul_rn(b, t));
}

template <typename TX, typename TF, int C>
__global__ void __launch_bounds__(BX * BY)
backward_warp_kernel(const TX* __restrict__ x, const TF* __restrict__ flow,
                     const bool* __restrict__ skip, TX* __restrict__ out,
                     int H, int W, int s)
{
    const int u = blockIdx.x * BX + threadIdx.x;
    const int v = blockIdx.y * BY + threadIdx.y;
    const int n = blockIdx.z;
    if (u >= W || v >= H) return;

    const int64_t plane = (int64_t)H * W;
    const TX* xn = x + n * plane * C;
    const int64_t pix = (int64_t)v * W + u;
    // output address: NHWC for s == 1, else the s2d block's channel slot
    int64_t o;
    if (s == 1) {
        o = (n * plane + pix) * C;
    } else {
        const int hs = H / s, ws = W / s;
        o = (((int64_t)n * hs + v / s) * ws + u / s) * (s * s * C) + ((v % s) * s + (u % s)) * C;
    }

    if (skip != nullptr && *skip) {
#pragma unroll
        for (int c = 0; c < C; ++c) out[o + c] = xn[pix * C + c];
        return;
    }

    const float2 f = load_pair(flow + (n * plane + pix) * 2);
    // NaN clamps to 0 (fmaxf returns the other operand), +-inf to the edge
    const float fx = fminf(fmaxf((float)u + f.x, 0.0f), (float)(W - 1));
    const float fy = fminf(fmaxf((float)v + f.y, 0.0f), (float)(H - 1));
    const float x0f = floorf(fx), y0f = floorf(fy);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    const float wx = fx - x0f, wy = fy - y0f;

    const TX* r0 = xn + (int64_t)y0 * W * C;
    const TX* r1 = xn + (int64_t)y1 * W * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float top = lerp(to_f32(r0[x0 * C + c]), to_f32(r0[x1 * C + c]), wx);
        const float bot = lerp(to_f32(r1[x0 * C + c]), to_f32(r1[x1 * C + c]), wx);
        out[o + c] = from_f32<TX>(lerp(top, bot, wy));
    }
}

template <typename TX, typename TF>
cudaError_t launch(const void* x, const void* flow, const void* skip, void* out,
                   int N, int H, int W, int C, int s, cudaStream_t stream)
{
    dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, N);
    dim3 block(BX, BY);
    auto xp = static_cast<const TX*>(x);
    auto fp = static_cast<const TF*>(flow);
    auto sp = static_cast<const bool*>(skip);
    auto op = static_cast<TX*>(out);
    switch (C) {
        case 1: backward_warp_kernel<TX, TF, 1><<<grid, block, 0, stream>>>(xp, fp, sp, op, H, W, s); break;
        case 2: backward_warp_kernel<TX, TF, 2><<<grid, block, 0, stream>>>(xp, fp, sp, op, H, W, s); break;
        case 3: backward_warp_kernel<TX, TF, 3><<<grid, block, 0, stream>>>(xp, fp, sp, op, H, W, s); break;
        case 4: backward_warp_kernel<TX, TF, 4><<<grid, block, 0, stream>>>(xp, fp, sp, op, H, W, s); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  x_dtype and flow_dtype: 0 float32, 1 bf16.
// skip: a device bool, or null for no skip.  s: 1 for NHWC out, else the
// space_to_depth factor (it must divide H and W).  Returns the
// cudaError_t of the launch (0 on success); unsupported arguments return
// cudaErrorInvalidValue.
extern "C" int backward_warp(const void* x, const void* flow, const void* skip, void* out,
                             int N, int H, int W, int C, int s, int x_dtype, int flow_dtype,
                             void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || C > 4 || s < 1 || H % s || W % s)
        return (int)cudaErrorInvalidValue;
    if ((H + BY - 1) / BY > 65535) return (int)cudaErrorInvalidValue;
    if (x_dtype == 1 && flow_dtype == 1)
        return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, flow, skip, out, N, H, W, C, s, st);
    if (x_dtype == 1 && flow_dtype == 0)
        return (int)launch<__nv_bfloat16, float>(x, flow, skip, out, N, H, W, C, s, st);
    if (x_dtype == 0 && flow_dtype == 1)
        return (int)launch<float, __nv_bfloat16>(x, flow, skip, out, N, H, W, C, s, st);
    if (x_dtype == 0 && flow_dtype == 0)
        return (int)launch<float, float>(x, flow, skip, out, N, H, W, C, s, st);
    return (int)cudaErrorInvalidValue;
}
