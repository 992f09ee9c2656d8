"""The port's weight-export and quality tools
(sharkshark_tpu_torch/tools/export_torch_{srvgg,egvsr,bsvd}.py and
quality_eval.py) against the JAX package's tools/, on the CPU.

- Each export reads a checkpoint of this package and writes a
  reference-layout .pth that the port's from_torch reads back exactly;
  its tensors equal, key for key, what the JAX tool's
  params_to_state_dict writes for the same parameters.
- quality_eval scores two frame trees: PSNR and tOF equal the JAX tool's
  (the same numpy and cv2 calls), LPIPS within 1e-5 (float32 convs summed
  in another order, as tests/test_torch_train_data.py).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from sharkshark_tpu_torch.models import bsvd, egvsr, srvgg
from sharkshark_tpu_torch.train import checkpoint, vsr
from sharkshark_tpu_torch.tools import export_torch_bsvd, export_torch_egvsr, export_torch_srvgg, quality_eval

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))


def _jax_tool(name):
    import importlib

    return importlib.import_module(name)


def _ckpt(tmp_path, params, step=3):
    state = vsr.new_train_state(params, "cpu", 1e-4, 0.9, 0.999)
    return checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state, step)


def _np(params):
    if isinstance(params, dict):
        return {k: _np(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_np(v) for v in params]
    return params.detach().numpy()


def _assert_same_state_dict(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k].to(torch.float32)), k


@pytest.mark.parametrize("num_conv", [2, 4])
def test_export_srvgg_round_trip(tmp_path, num_conv):
    params = srvgg.init_params(torch.Generator().manual_seed(0), srvgg.SRVGGConfig(num_feat=8, num_conv=num_conv))
    ckpt = _ckpt(tmp_path, params)
    out = str(tmp_path / "w" / "srvgg.pth")
    # the checkpoint root: its newest checkpoint
    res = export_torch_srvgg.main(["--ckpt", os.path.dirname(ckpt), "--out", out, "--num-conv", str(num_conv)])
    assert res["leaves"] == len(vsr.param_leaves(params))
    blob = torch.load(out, weights_only=True)
    _assert_same_state_dict(blob["params"], _jax_tool("export_torch_srvgg").params_to_state_dict(_np(params)))
    with pytest.raises(ValueError, match="num-conv"):
        export_torch_srvgg.main(["--ckpt", ckpt, "--out", out, "--num-conv", str(num_conv + 1)])


@pytest.mark.parametrize("degradation", ["BI", "BD"])
def test_export_egvsr_round_trip(tmp_path, degradation):
    cfg = egvsr.EGVSRConfig(nf=16, nb=2, degradation=degradation)
    params = egvsr.init_params(torch.Generator().manual_seed(1), cfg)
    ckpt = _ckpt(tmp_path, params)
    out = str(tmp_path / "egvsr.pth")
    export_torch_egvsr.main(["--ckpt", ckpt, "--out", out, "--nb", "2", "--degradation", degradation])
    sd = torch.load(out, weights_only=True)
    want = _jax_tool("export_torch_egvsr").params_to_state_dict(_np(params))
    assert ("upsample_func.kernels" in sd) == (degradation == "BD")
    kernels = sd.pop("upsample_func.kernels", None)
    _assert_same_state_dict(sd, want)
    if kernels is not None:
        from sharkshark_tpu.ops.resize import _tecogan_kernels

        assert torch.equal(kernels, torch.tensor(_tecogan_kernels(4), dtype=torch.float32))


def test_export_egvsr_from_a_gan_checkpoint(tmp_path):
    """A GAN checkpoint holds both networks: the export takes the
    generator's."""
    from sharkshark_tpu_torch.train import discriminators as D
    from sharkshark_tpu_torch.train import vsrgan

    cfg = vsrgan.VSRGANConfig(model_cfg=egvsr.EGVSRConfig(nf=16, nb=1),
                              disc_cfg=D.DiscriminatorConfig(spatial_size=32))
    state = vsrgan.create_gan_state(torch.Generator().manual_seed(2), cfg, device="cpu")
    ckpt = checkpoint.save_checkpoint(str(tmp_path / "gan"), state, 5)
    out = str(tmp_path / "egvsr_gan.pth")
    res = export_torch_egvsr.main(["--ckpt", ckpt, "--out", out, "--nb", "1"])
    assert res["leaves"] == len(vsr.param_leaves(state.params_g))
    back = egvsr.from_torch({k: v.numpy() for k, v in torch.load(out, weights_only=True).items()}, cfg.model_cfg)
    for a, b in zip(vsr.param_leaves(back), vsr.param_leaves(state.params_g)):
        assert torch.equal(a, b.detach())


def test_export_bsvd_round_trip(tmp_path):
    params = bsvd.init_params(torch.Generator().manual_seed(3))
    ckpt = _ckpt(tmp_path, params)
    out = str(tmp_path / "bsvd.pth")
    res = export_torch_bsvd.main(["--ckpt", ckpt, "--out", out])
    assert res["tensors"] == 64
    _assert_same_state_dict(torch.load(out, weights_only=True),
                            _jax_tool("export_torch_bsvd").params_to_state_dict(_np(params)))


def test_export_without_a_checkpoint_names_the_root(tmp_path):
    with pytest.raises(FileNotFoundError, match="no ckpt_"):
        export_torch_bsvd.main(["--ckpt", str(tmp_path), "--out", str(tmp_path / "x.pth")])


def _frame_trees(root, seed=0, n_seq=2, t=3, size=48):
    """gt/ and pred/ trees of PNG frames: pred = gt + seeded noise, and a
    sequence only gt has."""
    import cv2

    rng = np.random.default_rng(seed)
    for s in range(n_seq + 1):
        gt = rng.integers(0, 256, (t, size, size, 3), dtype=np.uint8)
        gt = cv2.GaussianBlur(gt.reshape(t * size, size, 3), (5, 5), 1.5).reshape(t, size, size, 3)
        pred = np.clip(gt.astype(int) + rng.integers(-12, 13, gt.shape), 0, 255).astype(np.uint8)
        for name, frames in (("gt", gt), ("pred", pred)):
            if name == "pred" and s == n_seq:
                continue
            d = root / name / f"seq_{s}"
            d.mkdir(parents=True)
            for i, f in enumerate(frames[: t - (s == 1 and name == "pred")]):
                cv2.imwrite(str(d / f"{i:04d}.png"), f[..., ::-1])
    return str(root / "gt"), str(root / "pred")


def test_quality_eval_matches_the_jax_tool(tmp_path):
    """PSNR, tOF and LPIPS (the minted pair, by path in both) over the
    sequences both trees hold, each over its common frames."""
    from sharkshark_tpu.train.metrics import MINTED_ALEX_PATH, MINTED_LIN_PATH

    gt, pred = _frame_trees(tmp_path)
    lp = ["--lpips-alexnet", MINTED_ALEX_PATH, "--lpips-linear", MINTED_LIN_PATH]
    args = ["--gt", gt, "--pred", pred, "--metrics", "PSNR", "tOF", "LPIPS", *lp]
    got = quality_eval.main(args + ["--json", str(tmp_path / "port.json"), "--device", "cpu"])
    _jax_tool("quality_eval").main(args + ["--json", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())["eval"]
    port = json.loads((tmp_path / "port.json").read_text())["eval"]
    assert sorted(got["sequences"]) == sorted(want["sequences"]) == ["seq_0", "seq_1"]
    for seq, metrics in want["sequences"].items():
        assert port["sequences"][seq]["PSNR"] == metrics["PSNR"]
        assert port["sequences"][seq]["tOF"] == metrics["tOF"]
        assert abs(port["sequences"][seq]["LPIPS"] - metrics["LPIPS"]) <= 1e-5
    assert port["lpips_weights"] == want["lpips_weights"] == "minted"
    assert got["average"]["PSNR"] == want["average"]["PSNR"]


def test_quality_eval_lpips_defaults_to_the_minted_pair_and_the_card(tmp_path):
    gt, pred = _frame_trees(tmp_path, seed=1)
    res = quality_eval.main(["--gt", gt, "--pred", pred, "--metrics", "PSNR", "LPIPS", "--device", "cpu"])
    assert np.isfinite(res["average"]["LPIPS"]) and res["average"]["PSNR"] > 20
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            quality_eval.main(["--gt", gt, "--pred", pred, "--metrics", "LPIPS"])
    # PSNR and tOF alone need no device
    assert quality_eval.main(["--gt", gt, "--pred", pred])["average"].keys() == {"PSNR", "tOF"}
