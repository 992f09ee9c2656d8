"""The port's kernels as torch operators (K1 `sharkshark::tsm_conv`, K3
`sharkshark::backward_warp`, K4 `sharkshark::conv_stack`),
the torch.export tool (sharkshark_tpu_torch/tools/export_model.py), the
per-device constants a traced call must not leave behind, and the BSVD
weight export at BSVD-64, on the CPU.

- `torch.library.opcheck` holds each op's CPU implementation (the plain
  version) against its schema and its fake implementation, and runs it
  through autograd's and AOT dispatch's registrations.  The ops are
  inference-only: each wrapper refuses a tensor that requires grad.
- export_model exports, saves, reloads and runs each of its three
  models; the reloaded program must equal the eager function (the same
  aten ops on the same input: exactly, on the CPU).
- Exporting first and then running eager in the same process gives real
  tensors equal to those of a process that never exported (the cached
  per-device tap tables, blur weights and gather indices were once made
  as fake tensors under the export's tracing and then handed to eager
  calls).
- export_torch_bsvd --variant 64 writes the reference layout the JAX
  tool writes and reads back bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from sharkshark_tpu_torch.models import bsvd
from sharkshark_tpu_torch.ops import conv_stack as cs
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.ops import warp as wp
from sharkshark_tpu_torch.tools import export_model, export_torch_bsvd
from sharkshark_tpu_torch.train import checkpoint, vsr
from sharkshark_tpu_torch.utils.device import device_cache

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _g(seed):
    return torch.Generator().manual_seed(seed)


def _tsm_args(t, n, h, w, c, bias, act, seed=0):
    g = _g(seed)
    return (torch.randn((t, n, h, w, c), generator=g), torch.randn((n, h, w, c), generator=g),
            torch.randn((n, h, w, c // 8), generator=g), torch.randn((3, 3, c, c), generator=g) * 0.05,
            torch.randn((c,), generator=g) if bias else None, act)


@pytest.mark.parametrize("t,c,bias,act", [(1, 64, True, "relu6"), (3, 128, False, "relu"), (2, 24, True, "none")])
def test_opcheck_tsm_conv(t, c, bias, act):
    args = _tsm_args(t, 2, 6, 7, c, bias, act)
    torch.library.opcheck(torch.ops.sharkshark.tsm_conv.default, args)
    torch.testing.assert_close(torch.ops.sharkshark.tsm_conv(*args), tsm.tsm_conv_plain(*args), rtol=0, atol=0)


@pytest.mark.parametrize("s2d_out,skip", [(0, None), (4, None), (2, True), (0, False)])
def test_opcheck_backward_warp(s2d_out, skip):
    g = _g(1)
    x, flow = torch.rand((2, 8, 12, 3), generator=g), torch.randn((2, 8, 12, 2), generator=g) * 3
    skip = None if skip is None else torch.tensor([skip])
    torch.library.opcheck(torch.ops.sharkshark.backward_warp.default, (x, flow, skip, s2d_out))
    torch.testing.assert_close(torch.ops.sharkshark.backward_warp(x, flow, skip, s2d_out),
                               wp.backward_warp_plain(x, flow, s2d_out=s2d_out, skip=skip), rtol=0, atol=0)


@pytest.mark.parametrize("n_layers,bias", [(1, True), (1, False), (3, True)])
def test_opcheck_conv_stack(n_layers, bias):
    g = _g(2)
    args = (torch.randn((2, 7, 9, 64), generator=g), torch.randn((n_layers, 3, 3, 64, 64), generator=g) * 0.05,
            torch.full((n_layers, 64), 0.25), torch.randn((n_layers, 64), generator=g) if bias else None)
    torch.library.opcheck(torch.ops.sharkshark.conv_stack.default, args)
    torch.testing.assert_close(torch.ops.sharkshark.conv_stack(*args), cs.fused_conv_stack_plain(*args),
                               rtol=0, atol=0)


def _wrapper_calls(requires_grad):
    """name -> a call of each kernel wrapper on small CPU tensors, its
    first input made to require grad or not."""
    g = _g(4)

    def leaf(*shape):
        return torch.randn(shape, generator=g).requires_grad_(requires_grad)

    k1 = _tsm_args(2, 1, 6, 7, 64, True, "relu6")
    flow = torch.randn((1, 8, 12, 2), generator=g)
    ws, alphas = torch.randn((2, 3, 3, 64, 64), generator=g) * 0.05, torch.full((2, 64), 0.2)
    return {
        "tsm_conv": lambda: tsm.tsm_conv(leaf(2, 1, 6, 7, 64), *k1[1:5], act="relu6"),
        "backward_warp_fast": lambda: wp.backward_warp_fast(leaf(1, 8, 12, 3), flow, s2d_out=4),
        "fused_conv_stack": lambda: cs.fused_conv_stack(leaf(1, 6, 6, 64), ws, alphas),
    }


@pytest.mark.parametrize("name", ["tsm_conv", "backward_warp_fast", "fused_conv_stack"])
def test_ops_are_inference_only(name):
    """The ops have no backward: a wrapper raises a clear error where
    autograd would differentiate through its op, and runs on a tensor
    that requires grad under no_grad, or on one that does not."""
    with pytest.raises(RuntimeError, match=f"{name}: the kernel's operator is inference-only"):
        _wrapper_calls(True)[name]()
    with torch.no_grad():
        assert not _wrapper_calls(True)[name]().requires_grad
    assert not _wrapper_calls(False)[name]().requires_grad


def test_wrappers_call_through_the_ops():
    """Each wrapper is one route: traced, its graph holds its op (K4 once
    for the whole stack), and the program equals the wrappers on the CPU."""
    k1 = _tsm_args(2, 1, 6, 7, 64, True, "relu6")
    g = _g(3)
    x, flow = torch.rand((1, 8, 12, 3), generator=g), torch.randn((1, 8, 12, 2), generator=g)
    xs, ws = torch.rand((1, 6, 6, 64), generator=g), torch.randn((3, 3, 3, 64, 64), generator=g) * 0.05
    alphas = torch.full((3, 64), 0.2)

    class Calls(torch.nn.Module):
        def forward(self, a, b, c):
            return (tsm.tsm_conv(a, *k1[1:5], act="relu6"), wp.backward_warp_fast(b, flow, s2d_out=4),
                    cs.fused_conv_stack(c, ws, alphas))

    ep = torch.export.export(Calls(), (k1[0], x, xs))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("sharkshark.tsm_conv.default") == 1
    assert targets.count("sharkshark.backward_warp.default") == 1
    assert targets.count("sharkshark.conv_stack.default") == 1
    for got, want in zip(ep.module()(k1[0], x, xs), Calls()(k1[0], x, xs)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("model,ops", [("srvgg", {"sharkshark.conv_stack.default": 32}),
                                       ("fsrcnn", {}),
                                       ("egvsr", {"sharkshark.backward_warp.default": 1})])
def test_export_model_round_trip(tmp_path, model, ops):
    out = str(tmp_path / f"{model}.pt2")
    res = export_model.main(["--model", model, "--shape", "1,16,24,3", "--out", out, "--device", "cpu",
                             "--speed-test", "--iters", "1"])
    assert res["kernel_ops"] == ops
    assert res["out_shape"] == [1, 64, 96, 1 if model == "fsrcnn" else 3]
    assert res["max_abs_err"] == 0.0 and res["bytes"] == os.path.getsize(out)
    # on the CPU the ops run their plain versions: no kernel launches
    assert res["launches"] == {"tsm_conv": 0, "backward_warp": 0, "conv_stack": 0}
    assert res["ms"] > 0 and res["eager_ms"] > 0


def test_export_model_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_model.main(["--model", "fsrcnn", "--shape", "1,8,8,1"])


def test_device_cache_keeps_no_fake_tensor():
    made = []

    @device_cache
    def table(n, device):
        made.append(n)
        return torch.arange(n, device=device), (torch.ones(n, device=device),)

    with FakeTensorMode():
        fake = table(3, torch.device("cpu"))
    assert isinstance(fake[0], FakeTensor)
    real = table(3, torch.device("cpu"))
    assert type(real[0]) is torch.Tensor and type(real[1][0]) is torch.Tensor
    assert table(3, torch.device("cpu")) is real and made == [3, 3]
    with torch.inference_mode():
        assert not table(4, torch.device("cpu"))[0].is_inference()


_REPAIR_SCRIPT = r"""
import sys
import numpy as np
import torch
from sharkshark_tpu_torch.models import egvsr, srvgg
from sharkshark_tpu_torch.ops import color
from sharkshark_tpu_torch.upscale import steps

mode, out = sys.argv[1], sys.argv[2]
g = torch.Generator().manual_seed(0)
ep = egvsr.init_params(g, egvsr.DEFAULT)
state = egvsr.init_recurrent_state(1, 16, 24)
cfg = srvgg.SRVGGConfig(num_feat=64, num_conv=2)
sp = srvgg.init_params(g, cfg)
spec = steps.UpscaleSpec(lr_shape=(24, 40), output_shape=(80, 144), compute_dtype=torch.float32)
lr = torch.rand((1, 20, 36, 3), generator=g)
calls = {
    "egvsr": (lambda x: egvsr.infer_step(ep, state, x)[0], torch.rand((1, 16, 24, 3), generator=g)),
    "srvgg_step": (lambda f: steps.upscale_multi(
        lambda p, x: srvgg.apply_down_rational(p, x, 2, 1, cfg=cfg, conv_stack=1), sp, f, spec),
        torch.randint(0, 256, (1, 48, 80, 3), dtype=torch.uint8, generator=g)),
    "color": (lambda hr: color.sharpen(color.local_color_match(hr, lr), 0.5) + color.blur(hr, 3, 0.5),
              torch.rand((1, 160, 288, 3), generator=g)),
}


class Step(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


if mode == "export_first":
    for fn, x in calls.values():
        torch.export.export(Step(fn), (x,))
res = {}
for name, (fn, x) in calls.items():
    y = fn(x)
    assert type(y) is torch.Tensor, (name, type(y))
    res[name] = y.numpy()
np.savez(out, **res)
"""


def test_export_first_then_eager_gives_real_tensors(tmp_path):
    """An export as a process's first call, then eager calls of EGVSR's
    step, the SR-only step on SRVGG's fused epilogue (area and bicubic
    resizes, color matching) and the colour ops: each returns a real
    tensor equal to the output of a process that never exported."""
    outs = {}
    for mode in ("export_first", "eager_only"):
        outs[mode] = str(tmp_path / f"{mode}.npz")
        proc = subprocess.run([sys.executable, "-c", _REPAIR_SCRIPT, mode, outs[mode]], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
    got, want = np.load(outs["export_first"]), np.load(outs["eager_only"])
    assert sorted(got.files) == sorted(want.files) == ["color", "egvsr", "srvgg_step"]
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_bsvd_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import export_torch_bsvd as jtool

    return jtool


def test_export_bsvd_variant64_round_trip(tmp_path):
    params = bsvd.init_params(_g(4), bsvd.BSVD_64)
    state = vsr.new_train_state(params, "cpu", 1e-4, 0.9, 0.999)
    ckpt = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state, 3)
    out = str(tmp_path / "bsvd64.pth")
    res = export_torch_bsvd.main(["--ckpt", ckpt, "--out", out, "--variant", "64"])
    assert res["tensors"] == 64
    sd = torch.load(out, weights_only=True)
    np_params = {net: {k: ({c: {n: t.numpy() for n, t in v[c].items()} for c in v} if k.endswith("_mem")
                           else {n: t.numpy() for n, t in v.items()}) for k, v in params[net].items()}
                 for net in params}
    want = _jax_bsvd_tool().params_to_state_dict(np_params)
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k], torch.as_tensor(np.asarray(want[k])).float()), k
    back = bsvd.from_torch({k: v.numpy() for k, v in sd.items()}, bsvd.BSVD_64)
    for a, b in zip(vsr.param_leaves(back), vsr.param_leaves(params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="BSVD-32"):
        export_torch_bsvd.main(["--ckpt", ckpt, "--out", str(tmp_path / "x.pth"), "--variant", "32"])
