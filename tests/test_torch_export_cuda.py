"""The kernels as torch operators on the card: `torch.library.opcheck`
of each op's CUDA implementation (K1 `sharkshark::tsm_conv`, K3
`sharkshark::backward_warp`, K4 `sharkshark::conv_stack`)
against its schema and fake implementation; K1 at BSVD-64's C=128 shape,
(4, 1, 360, 640, 128), against its plain version; and SRVGG and EGVSR
exported by tools/export_model.py, reloaded and run on the card, equal to
eager with their K4 and K3 launches counted through the program.

These tests need an NVIDIA GPU and nvcc, so they carry the `cuda` marker
and skip on a host without CUDA.  On the card, without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_export_cuda.py

Tolerance: rtol = atol = 0.05 on K1's bf16 outputs compared as float32,
as tests/test_torch_tsm_conv_cuda.py holds it; the reloaded programs run
the same ops as eager and must agree within export_model's own check.
"""

import pytest
import torch

from sharkshark_tpu_torch.ops import conv_stack as cs
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.ops import warp as wp
from sharkshark_tpu_torch.tools import export_model

pytestmark = pytest.mark.cuda
TOL = 0.05


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, dev, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _tsm_args(dev, t, n, h, w, c, seed, act="relu6"):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (_randn(g, dev, t, n, h, w, c), _randn(g, dev, n, h, w, c), _randn(g, dev, n, h, w, c // 8),
            _randn(g, dev, 3, 3, c, c, scale=0.05), _randn(g, dev, c, scale=0.1), act)


@pytest.mark.parametrize("c", [64, 128])
def test_opcheck_tsm_conv_on_the_card(dev, c):
    args = _tsm_args(dev, 2, 1, 20, 24, c, seed=c)
    before = tsm.launches
    torch.library.opcheck(torch.ops.sharkshark.tsm_conv.default, args)
    assert tsm.launches > before


@pytest.mark.parametrize("s2d_out,skip", [(0, None), (4, False), (4, True)])
def test_opcheck_backward_warp_on_the_card(dev, s2d_out, skip):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((1, 32, 48, 3), generator=g, device=dev).to(torch.bfloat16)
    flow = torch.randn((1, 32, 48, 2), generator=g, device=dev) * 4
    skip = None if skip is None else torch.tensor([skip], device=dev)
    before = wp.launches
    torch.library.opcheck(torch.ops.sharkshark.backward_warp.default, (x, flow, skip, s2d_out))
    assert wp.launches > before


@pytest.mark.parametrize("n_layers,bias", [(1, True), (1, False), (3, True)])
def test_opcheck_conv_stack_on_the_card(dev, n_layers, bias):
    g = torch.Generator(device=dev).manual_seed(2)
    args = (_randn(g, dev, 2, 20, 24, 64), _randn(g, dev, n_layers, 3, 3, 64, 64, scale=0.05),
            torch.full((n_layers, 64), 0.25, device=dev),
            _randn(g, dev, n_layers, 64, scale=0.1, dtype=torch.float32) if bias else None)
    before = cs.launches
    torch.library.opcheck(torch.ops.sharkshark.conv_stack.default, args)
    assert cs.launches > before


def test_k1_at_bsvd64_c128_shape(dev):
    """BSVD-64's C=128 shift convs run at half resolution of 720p, four
    times the pixels of BSVD-32's C=128 shape."""
    args = _tsm_args(dev, 4, 1, 360, 640, 128, seed=3)
    before = tsm.launches
    got = tsm.tsm_conv(*args)
    torch.cuda.synchronize()
    assert tsm.launches == before + 1
    want = tsm.tsm_conv_plain(*args)
    assert got.shape == want.shape == args[0].shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("model,launches", [("srvgg", {"tsm_conv": 0, "backward_warp": 0, "conv_stack": 32}),
                                            ("egvsr", {"tsm_conv": 0, "backward_warp": 1, "conv_stack": 0})])
def test_exported_program_equals_eager_on_the_card(dev, tmp_path, model, launches):
    res = export_model.main(["--model", model, "--shape", "1,64,96,3", "--out", str(tmp_path / f"{model}.pt2")])
    assert res["device"].startswith("cuda") and res["out_shape"] == [1, 256, 384, 3]
    assert res["launches"] == launches
