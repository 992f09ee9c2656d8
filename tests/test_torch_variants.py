"""The port's secondary generators (sharkshark_tpu_torch/models/variants.py:
ESPCN, VESPCN, SOF-VSR), the STN warp they use (ops/warp.py::
backward_warp_ac0) and the driver's espnet / vespnet / sofnet names,
against the JAX package on the CPU in float32, with the same weights
(the JAX package's seeded init handed to the port as numpy) and the same
inputs (numpy from a seed).

Tolerances: the warps atol 2e-5 (float32 coordinates; the JAX package's
jitted arithmetic rounds its divisions its own way); ESPCN and VESPCN
atol 1e-4 (float32 sums in another order through a dozen convs, as
tests/test_torch_egvsr.py); SOF-VSR, whose seeded outputs reach ~70, in
float64 within 1e-5 of the output's scale, and in float32 within three
times the JAX package's own float32 error (see its test); the driver's
sofnet, a plumbing check, within 2e-3 of the output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.models import variants as JV
from sharkshark_tpu.ops import backward_warp_ac0 as jbackward_warp_ac0
from sharkshark_tpu.train import driver as jdriver
from sharkshark_tpu_torch.models import variants as V
from sharkshark_tpu_torch.models.torch_import import to_tensors
from sharkshark_tpu_torch.ops import backward_warp_ac0
from sharkshark_tpu_torch.train import checkpoint, driver, vsr


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny shapes gain nothing from many CPU threads, and the test run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _flow(seed, *shape, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(2, 8, 8, 1), (1, 16, 24, 3), (2, 12, 20, 2)])
def test_backward_warp_ac0_matches_jax(shape):
    x = _rand(0, *shape)
    flow = _flow(1, *shape[:-1], 2)
    got = backward_warp_ac0(_t(x), _t(flow)).numpy()
    want = np.asarray(jax.jit(jbackward_warp_ac0)(x, flow))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # op by op the JAX function divides as the port does: bit for bit
    np.testing.assert_array_equal(got, np.asarray(jbackward_warp_ac0(x, flow)))


def test_backward_warp_ac0_zero_flow_is_identity():
    x = _rand(2, 1, 9, 13, 3)
    got = backward_warp_ac0(_t(x), torch.zeros(1, 9, 13, 2)).numpy()
    np.testing.assert_allclose(got, x, rtol=0, atol=2e-6)


@pytest.mark.parametrize("shape,scale", [((1, 8, 8, 1), 1.0), ((2, 12, 16, 1), 0.3)])
def test_sof_flow_warp_matches_jax(shape, scale):
    x = _rand(3, *shape)
    flow = _flow(4, *shape[:-1], 2, scale=scale)
    got = V._sof_flow_warp(_t(x), _t(flow)).numpy()
    want = np.asarray(jax.jit(JV._sof_flow_warp)(x, flow))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("method", ["subconv", "reconv", "deconv"])
@pytest.mark.parametrize("nc", [1, 3])
def test_espcn_matches_jax(method, nc):
    cfg = V.ESPCNConfig(scale=4, in_nc=nc, out_nc=nc, up_method=method)
    jcfg = JV.ESPCNConfig(scale=4, in_nc=nc, out_nc=nc, up_method=method)
    jp = _np_tree(JV.espcn_init(jax.random.PRNGKey(0), jcfg))
    x = _rand(5, 2, 12, 16, nc)
    got = V.espcn_apply(V.from_jax(jp), _t(x), cfg=cfg).numpy()
    want = np.asarray(jax.jit(lambda p, a: JV.espcn_apply(p, a, cfg=jcfg))(jp, x))
    assert got.shape == (2, 48, 64, nc)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("channel", [1, 3])
def test_vespcn_matches_jax(channel):
    cfg = V.VESPCNConfig(scale=4, channel=channel, depth=3)
    jcfg = JV.VESPCNConfig(scale=4, channel=channel, depth=3)
    jp = _np_tree(JV.vespcn_init(jax.random.PRNGKey(1), jcfg))
    seq = _rand(6, 3, 16, 16, channel)
    got = V.vespcn_apply(V.from_jax(jp), _t(seq), cfg=cfg).numpy()
    want = np.asarray(jax.jit(lambda p, a: JV.vespcn_apply(p, a, cfg=jcfg))(jp, seq))
    assert got.shape == (1, 64, 64, channel)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="window of 3"):
        V.vespcn_apply(V.from_jax(jp), _t(seq[:2]), cfg=cfg)


def test_sofvsr_matches_jax():
    """SOF-VSR's seeded init amplifies: its flows reach ~76 px and its
    outputs ~70, and float32 rounding grows with them (the JAX package's
    own float32 result lies ~3e-3 from its float64 one here).  So the
    function is held in float64, where both packages agree within 1e-5 of
    the output's scale (their warps sample in float32 alike), and the
    port's float32 result within three times the JAX package's own
    float32 error, both measured against the JAX package in float64."""
    jp = _np_tree(JV.sofvsr_init(jax.random.PRNGKey(3)))
    seq = _rand(7, 1, 12, 12, 3)
    got32 = V.sofvsr_apply(V.from_jax(jp), _t(seq)).numpy()
    got64 = V.sofvsr_apply(to_tensors(jp, "cpu", torch.float64), torch.from_numpy(seq).double()).numpy()
    want32 = np.asarray(jax.jit(JV.sofvsr_apply)(jp, seq))
    with jax.enable_x64(True):
        jp64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
        want64 = np.asarray(jax.jit(JV.sofvsr_apply)(jp64, jnp.asarray(seq, jnp.float64)))
    assert got32.shape == want64.shape == (1, 48, 48, 1)
    scale = np.abs(want64).max()
    np.testing.assert_allclose(got64, want64, rtol=0, atol=1e-5 * scale)
    floor = np.abs(want32 - want64).max()
    assert np.abs(got32 - want64).max() <= 3 * floor + 1e-4, (np.abs(got32 - want64).max(), floor)


@pytest.mark.parametrize("init,jinit,cfg,jcfg", [
    (V.espcn_init, JV.espcn_init, V.ESPCNConfig(), JV.ESPCNConfig()),
    (V.vespcn_init, JV.vespcn_init, V.VESPCNConfig(), JV.VESPCNConfig()),
    (V.sofvsr_init, JV.sofvsr_init, V.SOFVSRConfig(), JV.SOFVSRConfig()),
])
def test_seeded_init_has_the_jax_structure(init, jinit, cfg, jcfg):
    tp = init(torch.Generator().manual_seed(0), cfg)
    jp = V.from_jax(_np_tree(jinit(jax.random.PRNGKey(0), jcfg)))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert paths == [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tp)[0]]
    for path, a, b in zip(paths, jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert a.shape == b.shape, path
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), path


# ------------------------------------------------------------------ driver


@pytest.fixture(scope="module")
def derived(tmp_path_factory):
    """A tiny derived dataset: 32x32 GT (8x8 LR) panned sequences and a
    4-frame val sequence."""
    from sharkshark_tpu_torch.tools import make_derived_dataset as mdd

    root = tmp_path_factory.mktemp("variants_derived")
    mdd.write_stills(str(root / "stills"), 3, 64, seed=3)
    mdd.main(["--src", str(root / "stills"), "--out", str(root / "data"), "--holdout", "still_000.png",
              "--seqs", "2", "--tempo", "3", "--crop", "32", "--pan", "4", "--val-tempo", "4"])
    return root


def _config(root, name):
    data = root / "data"
    return {
        "scale": 4,
        "manual_seed": 0,
        "model": {"generator": {"name": name}},
        "dataset": {"degradation": {"type": "BI"},
                    "test": {"gt_seq_dir": str(data / "val" / "GT"), "lr_seq_dir": str(data / "val" / "LR")}},
        "train": {},
        "test": {"metrics": ["PSNR"], "psnr_colorspace": "y", "profile_size": [16, 24]},
    }


JAX_INITS = {"espnet": (JV.espcn_init, JV.ESPCNConfig(in_nc=3, out_nc=3)),
             "vespnet": (JV.vespcn_init, JV.VESPCNConfig(channel=3)),
             "sofnet": (JV.sofvsr_init, JV.SOFVSRConfig())}


@pytest.mark.parametrize("name,window", [("espnet", 1), ("vespnet", 3), ("sofnet", 3)])
def test_driver_variant_test_and_profile_on_the_cpu(derived, tmp_path, name, window):
    """--mode test from a checkpoint of this package (the JAX package wires
    no .pth import for these), its frames written; --mode profile on one
    window of frames.  A window generator scores the frames it outputs,
    the val sequence's middle two of four."""
    opt = _config(derived, name)
    gen = driver.define_generator(opt, device="cpu")
    assert gen["window"] == window and "from_torch" not in gen
    state = vsr.new_train_state(gen["init"](torch.Generator().manual_seed(0)), "cpu", 1e-4, 0.9, 0.999)
    checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state, 0)
    opt["model"]["generator"]["load_path"] = str(tmp_path / "ckpt")
    opt["test"]["res_dir"] = str(tmp_path / "res")
    cfg = str(tmp_path / "c.yml")
    import yaml

    with open(cfg, "w") as f:
        yaml.safe_dump(opt, f)
    res = driver.main(["--config", cfg, "--mode", "test", "--device", "cpu"])
    assert np.isfinite(res["test"]["PSNR"])
    assert len(list((tmp_path / "res").rglob("*.png"))) == 4 - window + 1
    stats = driver.main(["--config", cfg, "--mode", "profile", "--device", "cpu"])
    assert stats["flops"] > 0 and stats["params"] == sum(p.numel() for p in vsr.param_leaves(state.params))
    opt["model"]["generator"]["load_path"] = str(tmp_path / "weights.pth")
    with pytest.raises(ValueError, match="not wired"):
        driver.test(opt, device="cpu")


@pytest.mark.parametrize("name", ["espnet", "vespnet", "sofnet"])
def test_driver_variant_infer_matches_jax(derived, name):
    """The driver's infer on an LR clip (T, H, W, C) against the JAX
    driver's, on the JAX package's seeded weights: espnet and vespnet on
    RGB frames; sofnet on one channel (the JAX infer stacks the three
    frames' channels, which a 3-channel clip does not fit) and, on RGB
    frames, each channel as its own Y plane against the JAX infer on that
    channel."""
    opt = _config(derived, name)
    init, jcfg = JAX_INITS[name]
    jp = _np_tree(init(jax.random.PRNGKey(4), jcfg))
    jinfer = jax.jit(jdriver.define_generator(opt)["infer"])
    infer = driver.define_generator(opt, device="cpu")["infer"]
    lr = _rand(8, 4, 8, 12, 3)
    got = infer(V.from_jax(jp), _t(lr)).numpy()
    if name == "sofnet":
        want = np.concatenate([np.asarray(jinfer(jp, lr[..., c : c + 1])) for c in range(3)], axis=-1)
        atol = 1e-4 + 2e-3 * np.abs(want).max()  # SOF-VSR's seeded amplification (test_sofvsr_matches_jax)
        one = infer(V.from_jax(jp), _t(lr[..., :1])).numpy()
        np.testing.assert_allclose(one, want[..., :1], rtol=0, atol=atol)
    else:
        want = np.asarray(jinfer(jp, lr))
        atol = 1e-4
    assert got.shape == want.shape == ((4, 32, 48, 3) if name == "espnet" else (2, 32, 48, 3))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["espnet", "vespnet"])
def test_driver_variant_test_matches_the_jax_driver(derived, name):
    """test() on the same weights: the port's PSNR within 0.01 dB of the
    JAX driver's (uint8 outputs may differ by one level on a few pixels)."""
    opt = _config(derived, name)
    init, jcfg = JAX_INITS[name]
    jp = _np_tree(init(jax.random.PRNGKey(5), jcfg))
    got = driver.test(opt, params=V.from_jax(jp), device="cpu")["test"]["PSNR"]
    want = jdriver.test(opt, params=jax.tree.map(jnp.asarray, jp))["test"]["PSNR"]
    assert abs(got - want) <= 0.01, (got, want)
