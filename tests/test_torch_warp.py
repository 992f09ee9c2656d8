"""The port's backward warp (sharkshark_tpu_torch/ops/warp.py) against the
JAX package's, on the CPU, from the same numpy inputs: the plain
`backward_warp` against JAX `backward_warp` (the gather), and the plain
K3 function against the Pallas kernel `banded_backward_warp` run in
interpret mode, in both output layouts; the skip flag; N = 2 and shapes
the Pallas kernel refuses; a column origin (a width-sharded step's band
of the whole frame's warp) against the JAX whole-frame warp sliced to
the band.  The CUDA kernel itself is held against the plain version on
the card (tests/test_torch_warp_cuda.py, chip_smoke.py).

Tolerances: the plain version repeats the JAX arithmetic step by step in
float32, but XLA's CPU backend rounds the normalised grid differently in
its last bit (a division by a constant becomes a product with the
reciprocal, a multiply-add may be fused), which moves a sample point by
up to about W * 1e-7 px: at these widths (W <= 128) the values agree to
atol 2e-5, and the jitted jnp.linspace exactly.  Against the Pallas
kernel: atol 1e-4 in float32 compute (its hat-matrix products sum in
another order, tests/test_warp_band.py's bound), 2e-2 in bf16 compute
(the kernel rounds the source window and the hat weights to bf16,
tests/test_warp_band.py's bf16 bound).  The skip returns x bit-exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.ops import space_to_depth as jspace_to_depth
from sharkshark_tpu.ops.pallas.warp_band import WINDOW_FULL, banded_backward_warp, banded_warp_bases_for
from sharkshark_tpu.ops.warp import backward_warp as jbackward_warp
from sharkshark_tpu.ops.warp import grid_sample_bilinear as jgrid_sample
from sharkshark_tpu_torch.ops import _build, space_to_depth
from sharkshark_tpu_torch.ops import warp as wp
from sharkshark_tpu_torch.tools import bench_backward_warp, bench_tsm_conv

TIGHT = 2e-5


def _smooth_flow(rng, n, h, w, max_disp):
    """EGVSR-like flow as tests/test_warp_band.py makes it: uniform on a
    coarse grid, bilinearly upsampled, times max_disp."""
    coarse = rng.uniform(-1.0, 1.0, (n, max(h // 32, 2), max(w // 32, 2), 2)).astype(np.float32)
    flow = jax.image.resize(jnp.asarray(coarse), (n, h, w, 2), "bilinear")
    return np.asarray(flow * max_disp, np.float32)


def _const_flow(n, h, w, dx, dy):
    flow = np.zeros((n, h, w, 2), np.float32)
    flow[..., 0], flow[..., 1] = dx, dy
    return flow


def _case(kind, n, h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, h, w, c), dtype=np.float32)
    if kind == "rough95":
        flow = rng.uniform(-95.0, 95.0, (n, h, w, 2)).astype(np.float32)
    elif isinstance(kind, str):
        flow = _smooth_flow(rng, n, h, w, float(kind[len("smooth"):]))
    else:
        dx, dy = kind
        flow = _const_flow(n, h, w, dx, dy)
    return x, flow


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


CASES = ["smooth3", "smooth20", "smooth90", "rough95",
         (-80.5, 0.0), (80.5, 0.0), (0.0, -90.25), (30.5, 88.75)]


@pytest.mark.parametrize("kind", CASES, ids=str)
def test_plain_matches_jax_gather_f32(kind):
    x, flow = _case(kind, 1, 16, 128)
    want = np.asarray(jbackward_warp(jnp.asarray(x), jnp.asarray(flow)))
    got = wp.backward_warp(_t(x), _t(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TIGHT)


@pytest.mark.parametrize("n,h,w,c", [(2, 16, 128, 3), (1, 13, 37, 3), (2, 9, 20, 1), (3, 17, 30, 4)])
def test_plain_matches_jax_gather_ragged_and_batched(n, h, w, c):
    """N > 1 and shapes that are not multiples of 8 x 128, which the
    Pallas kernel refuses (its wrapper falls back to the gather)."""
    x, flow = _case("smooth20", n, h, w, c, seed=h + w)
    want = np.asarray(jbackward_warp(jnp.asarray(x), jnp.asarray(flow)))
    np.testing.assert_allclose(wp.backward_warp(_t(x), _t(flow)).numpy(), want, rtol=0, atol=TIGHT)
    # the K3 wrapper on a CPU tensor is the same plain function
    fast = wp.backward_warp_fast(_t(x), _t(flow)).numpy()
    np.testing.assert_allclose(fast, want, rtol=0, atol=TIGHT)


def test_grid_sample_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.random((2, 11, 19, 3), dtype=np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 7, 9, 2)).astype(np.float32)
    want = np.asarray(jgrid_sample(jnp.asarray(x), jnp.asarray(grid)))
    np.testing.assert_allclose(wp.grid_sample_bilinear(_t(x), _t(grid)).numpy(), want, rtol=0, atol=TIGHT)


def test_linspace_matches_jax():
    for n in (1, 2, 7, 128, 5120):
        want = np.asarray(jax.jit(lambda n=n: jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32))())
        np.testing.assert_array_equal(wp._linspace(n, "cpu").numpy(), want)


@pytest.mark.parametrize("s2d", [0, 4])
@pytest.mark.parametrize("kind", ["smooth3", "smooth20", "rough95", (30.5, 88.75)], ids=str)
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_k3_plain_matches_pallas_interpret(kind, s2d, compute):
    """The plain K3 function against the Pallas kernel, in the window
    that fits the flow (FULL for the rough one), NHWC and s2d_out=4."""
    h, w = 16, 128
    x, flow = _case(kind, 1, h, w, seed=11)
    if compute == "bfloat16":
        # both sides read the same bf16 image
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    jx, jf = jnp.asarray(x), jnp.asarray(flow)
    bx, by, (ok_full,) = banded_warp_bases_for(jf, (WINDOW_FULL,))
    assert bool(ok_full)
    want = banded_backward_warp(jx, jf, bx, by, window=WINDOW_FULL, compute_dtype=jnp.dtype(compute),
                                interpret=True, s2d_out=s2d)
    got = wp.backward_warp_plain(_t(x), _t(flow), s2d_out=s2d)
    assert tuple(got.shape) == want.shape
    atol = 1e-4 if compute == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("s2d", [0, 4])
def test_s2d_layout_is_space_to_depth_of_the_warp(s2d):
    x, flow = _case("smooth20", 2, 16, 24, seed=3)
    want = np.asarray(jbackward_warp(jnp.asarray(x), jnp.asarray(flow)))
    if s2d:
        want = np.asarray(jspace_to_depth(jnp.asarray(want), s2d))
    got = wp.backward_warp_plain(_t(x), _t(flow), s2d_out=s2d).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TIGHT)


@pytest.mark.parametrize("s2d", [0, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_skip_flag_returns_x_exactly(s2d, dtype):
    x, flow = _case("rough95", 2, 16, 20, seed=5)
    tx, tf = _t(x).to(dtype), _t(flow).to(dtype)
    got = wp.backward_warp_fast(tx, tf, s2d_out=s2d, skip=torch.tensor([True]))
    assert torch.equal(got, space_to_depth(tx, s2d) if s2d else tx)
    unset = wp.backward_warp_fast(tx, tf, s2d_out=s2d, skip=torch.tensor([False]))
    assert torch.equal(unset, wp.backward_warp_fast(tx, tf, s2d_out=s2d))


def test_bf16_flow_is_read_as_given():
    """A bf16 flow (the EGVSR path's) is widened exactly, not re-rounded:
    the warp along it equals the warp along its float32 copy."""
    x, flow = _case("smooth90", 1, 16, 32, seed=6)
    fb = _t(flow).to(torch.bfloat16)
    got = wp.backward_warp_plain(_t(x), fb)
    want = np.asarray(jbackward_warp(jnp.asarray(x), jnp.asarray(fb.float().numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TIGHT)


def test_cpu_tensor_never_touches_the_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load the kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    x, flow = _case("smooth3", 1, 8, 12, seed=7)
    before = wp.launches
    y = wp.backward_warp_fast(_t(x), _t(flow), s2d_out=4)
    assert y.shape == (1, 2, 3, 48) and wp.launches == before
    band = wp.backward_warp_fast(_t(x), _t(flow[:, :, 4:12]), s2d_out=4, col0=4)
    assert band.shape == (1, 2, 2, 48) and wp.launches == before


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty((1, 8, 8, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        wp.backward_warp_fast(x, torch.empty((1, 8, 8, 2), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        wp.backward_warp_fast(x, torch.empty((1, 8, 4, 2), device="meta"), s2d_out=4, col0=4)


# (H, W, col0, W', s2d_out): origins at 0, inside the frame and flush with
# its right edge, ragged widths, the whole frame
BANDS = [(12, 37, 0, 13, 0), (12, 37, 11, 13, 1), (12, 37, 24, 13, 0), (12, 38, 10, 14, 2),
         (12, 38, 24, 14, 2), (16, 52, 0, 20, 4), (16, 52, 16, 20, 4), (16, 52, 32, 20, 4),
         (16, 52, 0, 52, 4)]


def _band_flow(kind, rng, h, w, col0, wo):
    """A whole-frame flow (1, h, w, 2): "near" moves a few px, so most
    samples stay in the band; "beyond" moves every sample a band's width
    or more (left of a band right of the frame's centre, right of the
    others), out of the band but inside the frame; "past" sends samples
    past the frame's edges, where they clamp."""
    if kind == "near":
        return _smooth_flow(rng, 1, h, w, 3.0)
    if kind == "beyond":
        flow = _smooth_flow(rng, 1, h, w, 2.0).copy()
        flow[..., 0] += -(wo + 2.5) if col0 + wo / 2 > w / 2 else wo + 2.5
        return flow
    return rng.uniform(-2.0 * w, 2.0 * w, (1, h, w, 2)).astype(np.float32)


@pytest.mark.parametrize("kind", ["near", "beyond", "past"])
@pytest.mark.parametrize("h,w,col0,wo,s2d", BANDS, ids=str)
def test_column_origin_matches_columns_and_jax_whole_frame(h, w, col0, wo, s2d, kind):
    """The operator's CPU route with an origin: columns [col0, col0 + W')
    of the whole frame's warp, bit for bit backward_warp_columns (then the
    skip's select and space_to_depth), and within TIGHT of the JAX
    whole-frame backward_warp sliced to the band; with the skip set, the
    band's columns of x exactly."""
    rng = np.random.default_rng(h * w + col0 + s2d)
    x = rng.random((1, h, w, 3), dtype=np.float32)
    flow = _band_flow(kind, rng, h, w, col0, wo)
    band = flow[:, :, col0 : col0 + wo]
    tx, tf = _t(x), _t(band)

    def s2d_of(y):
        return space_to_depth(y, s2d) if s2d else y

    cols = wp.backward_warp_columns(tx, tf, col0)
    got = wp.backward_warp_fast(tx, tf, s2d_out=s2d, col0=col0)
    assert torch.equal(got, s2d_of(cols))
    assert torch.equal(wp.backward_warp_fast(tx, tf, s2d_out=s2d, skip=torch.tensor([False]), col0=col0), got)
    skipped = wp.backward_warp_fast(tx, tf, s2d_out=s2d, skip=torch.tensor([True]), col0=col0)
    assert torch.equal(skipped, s2d_of(tx[:, :, col0 : col0 + wo]))
    want = np.asarray(jbackward_warp(jnp.asarray(x), jnp.asarray(flow)))[:, :, col0 : col0 + wo]
    if s2d:
        want = np.asarray(jspace_to_depth(jnp.asarray(want), s2d))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TIGHT)
    if kind != "near":
        # the samples do leave the band
        u = col0 + np.arange(wo)[None, None, :] + band[..., 0]
        assert ((u < col0) | (u > col0 + wo - 1)).mean() > 0.5


@pytest.mark.parametrize("col0,wo,s2d,match", [
    (-1, 8, 0, "must lie in"),      # an origin left of the frame
    (9, 8, 0, "must lie in"),       # a band past the frame's right edge
    (0, 0, 0, "must lie in"),       # an empty band
    (4, 10, 4, "must divide"),      # a band width that s2d_out does not divide
    (4, 8, 3, "must divide"),       # nor H
])
def test_column_origin_refusals(col0, wo, s2d, match):
    x, flow = _case("smooth3", 1, 8, 16, seed=8)
    before = wp.launches
    with pytest.raises(ValueError, match=match):
        wp.backward_warp_fast(_t(x), _t(np.zeros((1, 8, wo, 2), np.float32)), s2d_out=s2d, col0=col0)
    with pytest.raises(ValueError, match=match):
        wp.backward_warp_plain(_t(x), _t(np.zeros((1, 8, wo, 2), np.float32)), s2d_out=s2d, col0=col0)
    assert wp.launches == before


def test_bench_bound_at_the_egvsr_shape():
    """tools/bench_backward_warp.py's bound at the EGVSR path's shape,
    (1, 2880, 5120, 3) bf16 with a bf16 flow: x and out once each and the
    flow once, 236 MB, take 0.0704 ms at 3.35 TB/s, more than its 15
    float32 operations a value take at 67 TFLOP/s; the skip moves x and
    out only."""
    flops, nbytes = bench_backward_warp.work()
    assert nbytes == 2 * (2880 * 5120 * 3 * 2) + 2880 * 5120 * 2 * 2 + 1
    assert round(nbytes / 1e6) == 236 and flops == 15 * 2880 * 5120 * 3
    b = bench_tsm_conv.bound(flops, nbytes, bench_tsm_conv.PEAK_F32_FLOPS)
    assert b["bound_by"] == "bytes" and round(b["bound_ms"], 4) == 0.0704
    flops, nbytes = bench_backward_warp.work(skipped=True)
    assert flops == 0 and nbytes == 2 * (2880 * 5120 * 3 * 2) + 1


def test_bench_bound_of_a_band():
    """tools/bench_backward_warp.py's work of a band: out and the band's
    flow once each, and x's window that the flow's taps reach once: a
    zero flow reads the band's columns and the right neighbours' column,
    a flow past the top-left corner a 2x2 window."""
    shape = (1, 16, 64, 3)
    out, flow = 16 * 20 * 3 * 2, 16 * 20 * 2 * 4
    flops, nbytes = bench_backward_warp.band_work(shape, 16, torch.zeros((1, 16, 20, 2)))
    assert flops == 15 * 16 * 20 * 3 and nbytes == out + 16 * 21 * 3 * 2 + flow + 1
    _, nbytes = bench_backward_warp.band_work(shape, 16, torch.full((1, 16, 20, 2), -1e4))
    assert nbytes == out + 2 * 2 * 3 * 2 + flow + 1


def test_bench_bands_are_the_mesh_egvsr_bands():
    """bench_backward_warp.BANDS are the HR columns of the bands that
    make_sharded_egvsr_step cuts a 720p frame into on a 1x4 mesh with the
    production FRNet (nb 10), as the service builds its spec."""
    from fractions import Fraction

    from sharkshark_tpu_torch.models import egvsr
    from sharkshark_tpu_torch.parallel import _bands, sharded
    from sharkshark_tpu_torch.upscale.steps import UpscaleSpec

    spec, frame_w = UpscaleSpec(lr_shape=(720, 1280), output_shape=(1440, 2560)), 1280
    a = _bands.alignment(8, [(Fraction(1280, frame_w), 1), *sharded._out_constraints(spec, frame_w)])
    bands = _bands.split_width(frame_w, [torch.device("cpu")] * 4, a, sharded.egvsr_radius(egvsr.PRODUCTION))
    assert tuple((4 * b.lo, 4 * (b.hi - b.lo)) for b in bands) == bench_backward_warp.BANDS
