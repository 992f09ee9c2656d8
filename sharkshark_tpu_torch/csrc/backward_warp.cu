// Bilinear backward warp of an NHWC image along a per-pixel flow, for
// NVIDIA Hopper (sm_90a): EGVSR's warp of the previous HR frame.
//
// Replaces: sharkshark_tpu/ops/pallas/warp_band.py::banded_backward_warp
// (the Pallas TPU kernel).  Same function as the port's plain version,
// sharkshark_tpu_torch/ops/warp.py::backward_warp_plain.
//
// What it computes.  x is (N, H, W, C), the flow and out (N, H, Wo, .):
// out is the columns [col0, col0 + Wo) of the whole frame's warp.
// out[n, v, u, :] = x sampled at (col0 + u + dx, v + dy), (dx, dy) =
// flow[n, v, u, :] in pixels, with grid_sample semantics (bilinear,
// align_corners=True, border clamp): the sample point is clamped to
// [0, W-1] x [0, H-1] of the whole frame, and its four neighbours (the
// second one clamped too) are lerped in float32.  col0 = 0 and Wo = W is
// the warp of the whole frame; a width-sharded step warps its band of
// columns out of the gathered previous frame.  x is bf16 or float32 with
// C = 1..4 channels; the flow is bf16 or float32; out has x's dtype.
// Options:
//   s = 2, 4: out is space_to_depth(warp(x), s), (N, H/s, Wo/s, s*s*C)
//           with channel (dy*s + dx)*C + c;
//   skip:   a device bool; when set, out is x's columns [col0, col0 + Wo)
//           (in out's layout), copied exactly.  EGVSR's scene-cut test
//           sets it on the device, so the host never waits for it.
//
// Bound on an H100 SXM (3.35 TB/s), at the EGVSR path's shape
// (1, 2880, 5120, 3), bf16 x and flow: x read once (88.5 MB), the flow
// read once (59.0 MB), out written once (88.5 MB) -> 236 MB -> 70 us,
// bytes-bound (about 15 flops per output value).
// tools/bench_backward_warp.py recomputes it from the tensors it times.
//
// Design.  The TPU kernel turns the gather into banded hat-matrix
// products, with per-tile window bases, edge padding, three window sizes
// and a gather fallback, because gathers are slow on a TPU.  On the card a
// gather is a few loads, so none of that is ported.  A 3-channel bf16
// pixel is 6 unaligned bytes; read and written one value at a time that
// is ~16 memory instructions a pixel.  So:
//   - Gathers by span: a tap row's neighbour pair (x0, x1) is 2*C
//     contiguous values (12 B for bf16 C = 3), read as the one or two
//     (three for float32 C = 3) aligned 16-byte chunks that cover it and
//     shifted into place with selects and funnel shifts.  At the right
//     edge x1 = x0, and the second pixel read is unused.  A span whose
//     chunks would run past the tensor's end (its last pixels) is read one
//     value at a time, so no load leaves x.
//   - Neighbouring lanes, neighbouring pixels: a warp owns a span of out
//     (NHWC: 32 x 8 / sizeof(x) pixels; s2d: 16 output pixels, s x s
//     blocks, 1.5 KB at s = 4, C = 3, bf16), and at each step its 32 lanes
//     compute 32 neighbouring pixels of one row, so their gathers fall on
//     few cache lines.  (Lanes that each own a whole group of pixels, 4 to
//     8 pixels apart, measured no faster than one value per load.)
//   - Each lane loads all its (dx, dy) pairs first, neighbouring lanes
//     neighbouring pairs, so no gather waits on a flow load.
//   - The values go to a per-warp stage in shared memory in out's layout,
//     and the warp writes its span with 16-byte stores, contiguous.
//   - The lerps in float32, each step rounded as the plain version rounds
//     it, so the kernel and the plain version agree as before.
//   - Locality: a 1-d grid in raster order, so the blocks in flight cover
//     a band of consecutive output rows and their source band (±96 rows,
//     192 x 5120 x 6 B = 5.9 MB) stays in the 50 MB L2; with an origin,
//     consecutive rows of out's columns, and their source window.
//   - The skip: the same path, with x's own values in place of the lerps.
// What is left is the flow's own spread: a flow whose gradient is ~2 px
// a pixel sends neighbouring lanes to different rows, and its gathers are
// bound by the sectors they pull from L2, not by instructions.
// x, the flow and out must be 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__host__ __device__ constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// A (dx, dy) pair as loaded (bf16 pairs stay packed in one register
// until used), and as floats.
template <typename TF> struct Pair;
template <> struct Pair<float> {
    float2 v;
    __device__ __forceinline__ void load(const float* p) { v = __ldg(reinterpret_cast<const float2*>(p)); }
    __device__ __forceinline__ float2 get() const { return v; }
};
template <> struct Pair<__nv_bfloat16> {
    __nv_bfloat162 v;
    __device__ __forceinline__ void load(const __nv_bfloat16* p) { v = __ldg(reinterpret_cast<const __nv_bfloat162*>(p)); }
    __device__ __forceinline__ float2 get() const { return __bfloat1622float2(v); }
};

// value k of a packed span: bf16 values two to a word (the first in the
// low half), float32 one to a word
template <typename T, int WORDS>
__device__ __forceinline__ float value(const uint32_t (&w)[WORDS], int k)
{
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[k]);
    else return __uint_as_float(k & 1 ? w[k >> 1] & 0xffff0000u : w[k >> 1] << 16);
}

// a * (1 - t) + b * t, each step rounded as the plain version rounds it
// (no fused multiply-add)
__device__ __forceinline__ float lerp(float a, float b, float t)
{
    return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, t)), __fmul_rn(b, t));
}

// The neighbour pair of one tap row: a = pixel x0, b = pixel x1 (= x0 at
// the right edge), from p = &row[x0 * C].  x is 16-byte aligned, so a
// pixel starts at most MISALIGN bytes into its 16-byte chunk.
template <typename TX, int C>
__device__ __forceinline__ void tap_pair(const TX* p, const TX* xend, bool edge, float (&a)[C], float (&b)[C])
{
    constexpr int PB = C * (int)sizeof(TX);       // bytes of a pixel
    constexpr int SB = 2 * PB;                    // bytes of the pair
    constexpr int MISALIGN = 16 - gcd(PB, 16);
    constexpr int CHUNKS = (MISALIGN + SB + 15) / 16;
    constexpr int CW = 4 * CHUNKS;                // words loaded
    constexpr int WORDS = SB / 4;                 // words of the pair, once shifted into place
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    const int off = (int)(addr & 15);
    const uint4* base = reinterpret_cast<const uint4*>(addr - off);
    const int chunks = (off + SB + 15) >> 4;
    if (reinterpret_cast<uintptr_t>(base + chunks) > reinterpret_cast<uintptr_t>(xend)) {
        // the tensor's last pixels: no vector may read past its end
#pragma unroll
        for (int c = 0; c < C; ++c) a[c] = to_f32(p[c]);
#pragma unroll
        for (int c = 0; c < C; ++c) b[c] = edge ? a[c] : to_f32(p[C + c]);
        return;
    }
    uint32_t w[CW];
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (i < chunks) q = __ldg(base + i);
        w[4 * i] = q.x, w[4 * i + 1] = q.y, w[4 * i + 2] = q.z, w[4 * i + 3] = q.w;
    }
    // shift left by off / 4 words (two select stages), then, for bf16 at
    // an odd half-word, by 16 bits
    auto at = [&](int k) { return k < CW ? w[k] : 0u; };
    const int q = off >> 2;
    uint32_t s1[WORDS + 2];
#pragma unroll
    for (int j = 0; j < WORDS + 2; ++j) s1[j] = q & 2 ? at(j + 2) : at(j);
    uint32_t t[WORDS + 1];
#pragma unroll
    for (int j = 0; j < WORDS + 1; ++j) t[j] = q & 1 ? s1[j + 1] : s1[j];
    if constexpr (sizeof(TX) == 2) {
        if (off & 2) {
#pragma unroll
            for (int j = 0; j < WORDS; ++j) t[j] = __funnelshift_r(t[j], t[j + 1], 16);
        }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = value<TX>(t, c);
#pragma unroll
    for (int c = 0; c < C; ++c) b[c] = edge ? a[c] : value<TX>(t, C + c);
}

// The output pixel at row v and frame column u (col0 plus its column in
// out) into dst (its C values in out's layout): x sampled at (u + f.x,
// v + f.y), or, with copy, x[n, v, u] itself.
template <typename TX, int C>
__device__ __forceinline__ void warp_pixel(const TX* x, const TX* xend, float2 f, bool copy, int64_t plane,
                                           int n, int v, int u, int H, int W, TX* dst)
{
    const TX* xn = x + n * plane * C;
    if (copy) {
#pragma unroll
        for (int c = 0; c < C; ++c) dst[c] = xn[((int64_t)v * W + u) * C + c];
        return;
    }
    // NaN clamps to 0 (fmaxf returns the other operand), +-inf to the edge
    const float fx = fminf(fmaxf((float)u + f.x, 0.0f), (float)(W - 1));
    const float fy = fminf(fmaxf((float)v + f.y, 0.0f), (float)(H - 1));
    const float x0f = floorf(fx), y0f = floorf(fy);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int y1 = min(y0 + 1, H - 1);
    const bool edge = x0 == W - 1;
    const float wx = fx - x0f, wy = fy - y0f;
    float a0[C], b0[C], a1[C], b1[C];
    tap_pair<TX, C>(xn + ((int64_t)y0 * W + x0) * C, xend, edge, a0, b0);
    tap_pair<TX, C>(xn + ((int64_t)y1 * W + x0) * C, xend, edge, a1, b1);
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = from_f32<TX>(lerp(lerp(a0[c], b0[c], wx), lerp(a1[c], b1[c], wx), wy));
}

// The output values of a warp's span: NHWC, 32 x 8 / sizeof(TX) pixels
// (8 * C bytes of out a lane, 256 * C a warp); s2d, 16 s x s blocks, s / 2
// columns of 32 pixels a lane.  (At s = 4, 4 or 16 pixels a lane instead
// of 8 measured slower on gentle flows.)
template <typename TX, int C, int S>
__host__ __device__ constexpr int span_values() { return S == 1 ? 32 * (8 / (int)sizeof(TX)) * C : 16 * S * S * C; }

// Steps (u, v, n) `step` pixels (or blocks) on in raster order, image
// after image.
__device__ __forceinline__ void advance(int& u, int& v, int& n, int step, int W, int H)
{
    u += step;
    while (u >= W) {
        u -= W;
        if (++v == H) v = 0, ++n;
    }
}

template <typename TX, typename TF, int C, int S>
__global__ void __launch_bounds__(THREADS)
backward_warp_kernel(const TX* __restrict__ x, const TX* __restrict__ xend, const TF* __restrict__ flow,
                     const bool* __restrict__ skip, TX* __restrict__ out, int N, int H, int W, int col0, int Wo)
{
    constexpr int VALS = span_values<TX, C, S>();
    constexpr int CHUNKS = VALS * (int)sizeof(TX) / 16;
    __shared__ __align__(16) TX stage[WARPS][VALS];
    const int lane = threadIdx.x & 31;
    TX* st = stage[threadIdx.x >> 5];
    const int64_t span = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int64_t plane = (int64_t)H * W;    // of x
    const int64_t oplane = (int64_t)H * Wo;  // of the flow and out
    const int64_t values = N * oplane * C;   // of out
    const int64_t first = span * VALS;       // the span's first output value
    if (first >= values) return;
    const bool copy = skip != nullptr && *skip;

    // Lane l computes the span's pixels l, l + 32, l + 64, ... of each row
    // it covers, so a warp's gathers read neighbouring source pixels; the
    // values go to the stage in out's order.  A lane loads all its (dx, dy)
    // pairs first, so that no gather waits for a flow load.
    if constexpr (S == 1) {
        constexpr int G = VALS / 32 / C;  // pixels a lane computes
        const int64_t p = first / C + lane;
        const int n0 = (int)(p / oplane);
        const int64_t r = p - n0 * oplane;
        const int v0 = (int)(r / Wo), u0 = (int)(r - (int64_t)v0 * Wo);
        Pair<TF> f[G];
        if (!copy) {
#pragma unroll
            for (int i = 0; i < G; ++i)
                if (p + i * 32 < N * oplane) f[i].load(flow + 2 * (p + i * 32));
        }
        int n = n0, v = v0, u = u0;
#pragma unroll
        for (int i = 0; i < G; ++i) {
            if (n < N)
                warp_pixel<TX, C>(x, xend, f[i].get(), copy, plane, n, v, col0 + u, H, W, st + (i * 32 + lane) * C);
            advance(u, v, n, 32, Wo, H);
        }
    } else {
        // the span is 16 blocks in raster order; lane l computes column
        // (j * 32 + l) of the span's S-row strip, for each j and row dy
        constexpr int J = S / 2;
        const int hs = H / S, ws = Wo / S;
        const int64_t g = first / (S * S * C) + lane / S;
        int n[J], by[J], bx[J];
        n[0] = (int)(g / ((int64_t)hs * ws));
        const int64_t r = g - (int64_t)n[0] * hs * ws;
        by[0] = (int)(r / ws), bx[0] = (int)(r - (int64_t)by[0] * ws);
#pragma unroll
        for (int j = 1; j < J; ++j) {
            n[j] = n[j - 1], by[j] = by[j - 1], bx[j] = bx[j - 1];
            advance(bx[j], by[j], n[j], 32 / S, ws, hs);
        }
        const int dx = lane % S;
        Pair<TF> f[J][S];
        if (!copy) {
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
                for (int dy = 0; dy < S; ++dy)
                    if (n[j] < N)
                        f[j][dy].load(flow + 2 * (n[j] * oplane + (int64_t)(by[j] * S + dy) * Wo + bx[j] * S + dx));
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
            if (n[j] >= N) continue;
            TX* dst = st + ((j * 32 + lane) / S) * (S * S * C) + dx * C;
#pragma unroll
            for (int dy = 0; dy < S; ++dy)
                warp_pixel<TX, C>(x, xend, f[j][dy].get(), copy, plane, n[j], by[j] * S + dy, col0 + bx[j] * S + dx,
                                  H, W, dst + dy * S * C);
        }
    }
    __syncwarp();
    // the span to out: 16-byte chunks, a warp's stores contiguous
    TX* o = out + first;
    if (first + VALS <= values) {
#pragma unroll
        for (int k = lane; k < CHUNKS; k += 32)
            reinterpret_cast<uint4*>(o)[k] = reinterpret_cast<const uint4*>(st)[k];
    } else {
        for (int64_t k = lane; first + k < values; k += 32) o[k] = st[k];
    }
}

template <typename TX, typename TF, int C>
cudaError_t launch_c(const void* x, const void* flow, const void* skip, void* out, int N, int H, int W, int col0,
                     int Wo, int s, cudaStream_t stream)
{
    auto xp = static_cast<const TX*>(x);
    auto fp = static_cast<const TF*>(flow);
    auto sp = static_cast<const bool*>(skip);
    auto op = static_cast<TX*>(out);
    const int64_t values = (int64_t)N * H * Wo * C;  // of out
    const int64_t per_block = (int64_t)WARPS * (s == 1   ? span_values<TX, C, 1>()
                                                : s == 2 ? span_values<TX, C, 2>()
                                                         : span_values<TX, C, 4>());
    const int64_t blocks = (values + per_block - 1) / per_block;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    decltype(&backward_warp_kernel<TX, TF, C, 1>) kernel;
    switch (s) {
        case 1: kernel = backward_warp_kernel<TX, TF, C, 1>; break;
        case 2: kernel = backward_warp_kernel<TX, TF, C, 2>; break;
        case 4: kernel = backward_warp_kernel<TX, TF, C, 4>; break;
        default: return cudaErrorInvalidValue;
    }
    // x's end comes as a parameter: derived in the kernel beside out's
    // count, it made ptxas spill in the s2d kernels, ~8 % slower on an H100
    kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(xp, xp + (int64_t)N * H * W * C, fp, sp, op, N, H, W, col0, Wo);
    return cudaGetLastError();
}

template <typename TX, typename TF>
cudaError_t launch(const void* x, const void* flow, const void* skip, void* out, int N, int H, int W, int col0, int Wo,
                   int C, int s, cudaStream_t stream)
{
    switch (C) {
        case 1: return launch_c<TX, TF, 1>(x, flow, skip, out, N, H, W, col0, Wo, s, stream);
        case 2: return launch_c<TX, TF, 2>(x, flow, skip, out, N, H, W, col0, Wo, s, stream);
        case 3: return launch_c<TX, TF, 3>(x, flow, skip, out, N, H, W, col0, Wo, s, stream);
        case 4: return launch_c<TX, TF, 4>(x, flow, skip, out, N, H, W, col0, Wo, s, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// C interface for ctypes.  x is (N, H, W, C), the flow (N, H, Wo, 2);
// out is the columns [col0, col0 + Wo) of the warp (col0 = 0, Wo = W: the
// whole frame).  x_dtype and flow_dtype: 0 float32, 1 bf16.  skip: a
// device bool, or null for no skip.  s: 1 for NHWC out, else the
// space_to_depth factor, 2 or 4 (it must divide H and Wo).  x, flow and
// out 16-byte aligned.  Returns the cudaError_t of the launch (0 on
// success); unsupported arguments return cudaErrorInvalidValue.
extern "C" int backward_warp(const void* x, const void* flow, const void* skip, void* out,
                             int N, int H, int W, int col0, int Wo, int C, int s, int x_dtype, int flow_dtype,
                             void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (N < 1 || H < 1 || W < 1 || C < 1 || C > 4 || (s != 1 && s != 2 && s != 4) || H % s)
        return (int)cudaErrorInvalidValue;
    if (col0 < 0 || Wo < 1 || (int64_t)col0 + Wo > W || Wo % s)
        return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(flow) | reinterpret_cast<uintptr_t>(out)) & 15)
        return (int)cudaErrorInvalidValue;
    if (x_dtype == 1 && flow_dtype == 1)
        return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, flow, skip, out, N, H, W, col0, Wo, C, s, st);
    if (x_dtype == 1 && flow_dtype == 0)
        return (int)launch<__nv_bfloat16, float>(x, flow, skip, out, N, H, W, col0, Wo, C, s, st);
    if (x_dtype == 0 && flow_dtype == 1)
        return (int)launch<float, __nv_bfloat16>(x, flow, skip, out, N, H, W, col0, Wo, C, s, st);
    if (x_dtype == 0 && flow_dtype == 0)
        return (int)launch<float, float>(x, flow, skip, out, N, H, W, col0, Wo, C, s, st);
    return (int)cudaErrorInvalidValue;
}
