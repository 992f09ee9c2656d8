"""The port's model zoo (sharkshark_tpu_torch/models/{fsrcnn,rrdbnet,zoo}.py,
ops.conv_transpose2d and SRVGG's ANIMEVIDEO_V3) against the JAX
package's, on the CPU in float32, with the same weights: the JAX
parameter pytrees handed over as numpy through from_jax, or both packages
loading the same .pth files.

Tolerances: conv_transpose2d at atol 1e-5 (one op); FSRCNN, RRDBNet and
SRVGG at atol 1e-4 on values of order 1 (float32 sums taken in another
order); weight loading must agree exactly.  No test reaches a download:
the zoo's downloader is replaced by one that fails."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.models import fsrcnn as jfsrcnn
from sharkshark_tpu.models import rrdbnet as jrrdbnet
from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu.models import torch_import as jti
from sharkshark_tpu.models import zoo as jzoo
from sharkshark_tpu.ops import conv_transpose2d as jconv_transpose2d
from sharkshark_tpu_torch.models import fsrcnn, rrdbnet, srvgg, torch_import, zoo
from sharkshark_tpu_torch.ops import conv_stack as cs
from sharkshark_tpu_torch.ops import conv_transpose2d

ATOL = 1e-4


@pytest.fixture(autouse=True)
def no_download(monkeypatch):
    def refuse(url, path):
        raise ConnectionError("downloads are off in the tests")

    monkeypatch.setattr(zoo, "_download", refuse)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _sd_numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _close(got, want, atol=ATOL):
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=atol)


# ---------------------------------------------------------- conv_transpose2d


@pytest.mark.parametrize("cin,cout,k,stride,pad,out_pad", [
    (56, 1, 9, 4, 4, 3),   # FSRCNN's x4 head: 4H x 4W out
    (56, 1, 9, 2, 4, 1),   # FSRCNN's x2 head
    (8, 3, 3, 2, 1, 1),
])
def test_conv_transpose2d_matches_jax(cin, cout, k, stride, pad, out_pad):
    """The port keeps torch's (I, O, kh, kw) weight; the JAX op takes the
    same weight flipped, HWIO, as its torch import makes it."""
    rng = np.random.default_rng(cin + k)
    x = rng.standard_normal((2, 6, 7, cin)).astype(np.float32)
    w = (rng.standard_normal((cin, cout, k, k)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    jw = jti.conv_transpose_from_torch({"d.weight": w, "d.bias": b}, "d.")
    want = jconv_transpose2d(jnp.asarray(x), jnp.asarray(jw["w"]), jnp.asarray(b), stride=stride,
                             padding=pad, output_padding=out_pad)
    tw = torch_import.conv_transpose_from_torch({"d.weight": w, "d.bias": b}, "d.")
    got = conv_transpose2d(torch.from_numpy(x), torch.from_numpy(tw["w"]), torch.from_numpy(tw["b"]),
                           stride=stride, padding=pad, output_padding=out_pad)
    assert got.shape == (2, (6 - 1) * stride - 2 * pad + k + out_pad, (7 - 1) * stride - 2 * pad + k + out_pad,
                         cout)
    if stride == 4:
        assert got.shape[1:3] == (24, 28)
    _close(got, want, atol=1e-5)
    np.testing.assert_array_equal(tw["w"], w)  # no flip, no transpose


# ------------------------------------------------------------------ FSRCNN


def _jax_fsrcnn(seed=0):
    """JAX init, with the deconv scaled up so the output is not flat (the
    reference's deconv std of 0.001 leaves it near a constant)."""
    jp = _np(jfsrcnn.init_params(jax.random.PRNGKey(seed)))
    jp["deconv"]["w"] = jp["deconv"]["w"] * 100
    return jp


@pytest.mark.parametrize("factor", [4, 2])
def test_fsrcnn_matches_jax(factor):
    jp = _jax_fsrcnn()
    tp = fsrcnn.from_jax(jp)
    x = np.random.default_rng(1).random((2, 10, 12, 1)).astype(np.float32)
    want = jfsrcnn.apply(jp, jnp.asarray(x), factor=factor)
    got = fsrcnn.apply(tp, torch.from_numpy(x), factor=factor)
    assert got.shape == (2, 10 * factor, 12 * factor, 1)
    assert float(np.std(np.asarray(want))) > 0.02
    _close(got, want)


def test_fsrcnn_rgb_rides_the_batch():
    tp = fsrcnn.from_jax(_jax_fsrcnn(1))
    x = torch.from_numpy(np.random.default_rng(2).random((2, 6, 8, 3)).astype(np.float32))
    got = fsrcnn.apply_rgb(tp, x)
    assert got.shape == (2, 24, 32, 3)
    for c in range(3):
        _close(got[..., c], fsrcnn.apply(tp, x[..., c : c + 1])[..., 0], atol=1e-6)


def test_fsrcnn_checkpoint_layout():
    """to_torch writes the reference's keys; both packages' from_torch
    read them back into the same weights (the port's deconv unflipped)."""
    tp = fsrcnn.init_params(torch.Generator().manual_seed(3))
    sd = fsrcnn.to_torch(tp)
    assert sd["deconv.weight"].shape == (fsrcnn.D, 1, 9, 9)
    assert sd["feature_extraction.0.weight"].shape == (fsrcnn.D, 1, 5, 5)
    assert len(sd) == 7 * 2 + 7 + 2  # 7 convs with biases, 7 PReLUs, the deconv
    back = fsrcnn.from_torch(_sd_numpy(sd))
    assert _leaves_equal(back, tp)
    assert _leaves_equal(fsrcnn.from_jax(_np(jfsrcnn.from_torch(_sd_numpy(sd)))), tp)


# ----------------------------------------------------------------- RRDBNet


@pytest.mark.parametrize("scale", [4, 2])
def test_rrdbnet_matches_jax(scale):
    jcfg = jrrdbnet.RRDBConfig(num_block=2, num_feat=16, num_grow_ch=8, scale=scale)
    cfg = rrdbnet.RRDBConfig(num_block=2, num_feat=16, num_grow_ch=8, scale=scale)
    jp = _np(jrrdbnet.init_params(jax.random.PRNGKey(scale), jcfg))
    tp = rrdbnet.from_jax(jp)
    x = np.random.default_rng(scale).random((2, 8, 12, 3)).astype(np.float32)
    want = jrrdbnet.apply(jp, jnp.asarray(x), cfg=jcfg)
    got = rrdbnet.apply(tp, torch.from_numpy(x), cfg=cfg)
    assert got.shape == (2, 8 * scale, 12 * scale, 3)
    _close(got, want)
    # the in-place route (autograd off) computes the same values
    with torch.inference_mode():
        _close(rrdbnet.apply(tp, torch.from_numpy(x), cfg=cfg), want)


def test_rrdbnet_checkpoint_layout():
    cfg = rrdbnet.RRDBConfig(num_block=2, num_feat=16, num_grow_ch=8, scale=2)
    tp = rrdbnet.init_params(torch.Generator().manual_seed(5), cfg)
    sd = rrdbnet.to_torch(tp)
    assert sd["conv_first.weight"].shape == (16, 12, 3, 3)  # pixel-unshuffled input
    assert sd["body.1.rdb3.conv5.weight"].shape == (16, 16 + 4 * 8, 3, 3)
    assert len(sd) == 2 * (6 + 2 * 3 * 5)
    assert _leaves_equal(rrdbnet.from_torch(_sd_numpy(sd), cfg), tp)
    jcfg = jrrdbnet.RRDBConfig(num_block=2, num_feat=16, num_grow_ch=8, scale=2)
    assert _leaves_equal(rrdbnet.from_jax(_np(jrrdbnet.from_torch(_sd_numpy(sd), jcfg))), tp)


def test_rrdbnet_configs_match_jax():
    for name in ("X4PLUS", "X4PLUS_ANIME_6B", "X2PLUS"):
        assert tuple(getattr(rrdbnet, name)) == tuple(getattr(jrrdbnet, name))


# ------------------------------------------------------------ ANIMEVIDEO_V3


def test_animevideo_v3_shape_through_k4_plain():
    """A 2-layer SRVGG of ANIMEVIDEO_V3's width (64 features, PReLU), its
    body through K4's wrapper (the plain version on the CPU), against the
    JAX package's apply."""
    jcfg = jsrvgg.ANIMEVIDEO_V3._replace(num_conv=2)
    cfg = srvgg.ANIMEVIDEO_V3._replace(num_conv=2)
    assert srvgg.resolve_conv_stack(cfg, None) == 1
    jp = _np(jsrvgg.init_params(jax.random.PRNGKey(7), jcfg))
    tp = srvgg.from_jax(jp)
    x = np.random.default_rng(7).random((2, 9, 13, 3)).astype(np.float32)
    got = srvgg.apply(tp, torch.from_numpy(x), cfg=cfg, conv_stack=1)
    _close(got, jsrvgg.apply(jp, jnp.asarray(x), cfg=jcfg))


def test_animevideo_v3_makes_16_k4_calls(monkeypatch):
    assert tuple(srvgg.ANIMEVIDEO_V3) == tuple(jsrvgg.ANIMEVIDEO_V3)
    calls = []
    plain = cs.fused_conv_stack

    def counting(x, w, *args):
        calls.append(w.shape[0])
        return plain(x, w, *args)

    monkeypatch.setattr(cs, "fused_conv_stack", counting)
    tp = srvgg.init_params(torch.Generator().manual_seed(8), srvgg.ANIMEVIDEO_V3)
    out = srvgg.apply(tp, torch.rand(1, 4, 5, 3), cfg=srvgg.ANIMEVIDEO_V3,
                      conv_stack=srvgg.resolve_conv_stack(srvgg.ANIMEVIDEO_V3, None))
    assert out.shape == (1, 16, 20, 3)
    assert calls == [1] * 16


def test_srvgg_checkpoint_layout():
    cfg = srvgg.SRVGGConfig(num_feat=16, num_conv=2)
    tp = srvgg.init_params(torch.Generator().manual_seed(9), cfg)
    sd = srvgg.to_torch(tp)
    assert sd["body.6.weight"].shape == (48, 16, 3, 3)  # the tail conv
    assert _leaves_equal(srvgg.from_torch(_sd_numpy(sd), cfg), tp)


# --------------------------------------------------------------------- zoo


def test_zoo_table_covers_reference_models():
    """The JAX package's zoo cases, and the same table: names, configs,
    scales, URLs and DNI pairing."""
    expected = {
        "RealESRGAN_x4plus", "RealESRNet_x4plus", "RealESRGAN_x4plus_anime_6B",
        "RealESRGAN_x2plus", "realesr-animevideov3", "realesr-general-x4v3",
    }
    assert expected == set(zoo.ZOO) == set(jzoo.ZOO)
    assert zoo.ZOO["realesr-general-x4v3"].dni_partner == "realesr-general-wdn-x4v3"
    assert zoo.ZOO["RealESRGAN_x2plus"].scale == 2
    for name, entry in zoo.ZOO.items():
        jentry = jzoo.ZOO[name]
        assert (entry.arch, tuple(entry.cfg), entry.scale, entry.urls, entry.dni_partner) == (
            jentry.arch, tuple(jentry.cfg), jentry.scale, jentry.urls, jentry.dni_partner), name


@pytest.mark.parametrize("name", ["realesr-general-x4v3", "RealESRGAN_x4plus_anime_6B"])
def test_build_random_init(name):
    fn, params, scale = zoo.build_sr_model(name, random_init=True, device="cpu")
    with torch.inference_mode():
        out = fn(params, torch.zeros((1, 8, 8, 3)))
    assert out.shape == (1, 8 * scale, 8 * scale, 3)


@pytest.mark.parametrize("name,need_partner,files", [
    ("RealESRGAN_x2plus", True, 1),
    ("realesr-general-x4v3", True, 2),
    ("realesr-general-x4v3", False, 1),
])
def test_missing_weights_raise_with_url(tmp_path, name, need_partner, files):
    with pytest.raises(FileNotFoundError) as e:
        zoo.fetch_weights(name, weight_dir=str(tmp_path), need_partner=need_partner)
    assert "github.com" in str(e.value) and "downloads are off" in str(e.value)
    # with every file present, nothing is fetched
    urls = zoo.ZOO[name].urls[-files:]
    for url in urls:
        (tmp_path / url.rsplit("/", 1)[1]).write_bytes(b"")
    got = zoo.fetch_weights(name, weight_dir=str(tmp_path), need_partner=need_partner)
    assert got == [str(tmp_path / u.rsplit("/", 1)[1]) for u in urls]


def test_weight_dir_comes_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("SHARKSHARK_WEIGHT_DIR", str(tmp_path))
    assert zoo.default_weight_dir() == str(tmp_path)
    (tmp_path / "RealESRGAN_x2plus.pth").write_bytes(b"")
    assert zoo.fetch_weights("RealESRGAN_x2plus") == [str(tmp_path / "RealESRGAN_x2plus.pth")]


def _save(sd, path):
    torch.save({"params_ema": sd}, path)
    return str(path)


def test_build_sr_model_from_a_file_matches_jax(tmp_path):
    name = "RealESRGAN_x4plus_anime_6B"
    tp = rrdbnet.init_params(torch.Generator().manual_seed(10), rrdbnet.X4PLUS_ANIME_6B)
    path = _save(rrdbnet.to_torch(tp), tmp_path / "anime6b.pth")
    fn, params, scale = zoo.build_sr_model(name, model_path=path, device="cpu")
    jfn, jparams, jscale = jzoo.build_sr_model(name, model_path=path)
    assert scale == jscale == 4
    assert _leaves_equal(params, tp)
    x = np.random.default_rng(10).random((1, 6, 7, 3)).astype(np.float32)
    with torch.inference_mode():
        got = fn(params, torch.from_numpy(x))
    _close(got, jfn(jparams, jnp.asarray(x)))


def test_build_sr_model_dni_blend_matches_jax(tmp_path):
    """realesr-general-x4v3 at denoise strength 0.5 from a weight directory
    that holds both files: 0.5 x general + 0.5 x wdn, as the JAX builder
    blends them; the port's body runs through K4's wrapper."""
    cfg = srvgg.GENERAL_X4V3
    for seed, url in zip((11, 12), zoo.ZOO["realesr-general-x4v3"].urls):
        tp = srvgg.init_params(torch.Generator().manual_seed(seed), cfg)
        _save(srvgg.to_torch(tp), tmp_path / url.rsplit("/", 1)[1])
    fn, params, _ = zoo.build_sr_model("realesr-general-x4v3", denoise_strength=0.5,
                                       weight_dir=str(tmp_path), device="cpu")
    jfn, jparams, _ = jzoo.build_sr_model("realesr-general-x4v3", denoise_strength=0.5,
                                          weight_dir=str(tmp_path))
    _close(params["convs"][3]["w"], jparams["convs"][3]["w"], atol=0)
    sharp, _, _ = zoo.build_sr_model("realesr-general-x4v3", weight_dir=str(tmp_path), device="cpu")
    x = np.random.default_rng(12).random((1, 6, 7, 3)).astype(np.float32)
    got = fn(params, torch.from_numpy(x))
    _close(got, jfn(jparams, jnp.asarray(x)))
    assert not torch.allclose(got, sharp(srvgg.from_torch(torch_import.load_state_dict(
        str(tmp_path / "realesr-general-x4v3.pth")), cfg), torch.from_numpy(x)))


def test_build_sr_model_refuses_what_it_cannot_run(tmp_path):
    with pytest.raises(FileNotFoundError):
        zoo.build_sr_model("realesr-animevideov3", model_path=str(tmp_path / "absent.pth"), device="cpu")
    with pytest.raises(ValueError, match="no SRVGG body"):
        zoo.build_sr_model("RealESRGAN_x2plus", random_init=True, device="cpu", conv_stack=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            zoo.build_sr_model("realesr-animevideov3", random_init=True)
