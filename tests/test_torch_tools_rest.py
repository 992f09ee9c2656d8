"""The port's last four tools (sharkshark_tpu_torch/tools/warp_fidelity,
ingest_weights, bench_matrix, mint_lpips) against the JAX package's
tools/, on the CPU, and the port's package surface against the JAX
package's.

- warp_fidelity: the flow from one numpy-seeded coarse field and the
  warps at 64x128 against jax.image.resize, the JAX Pallas kernel
  banded_backward_warp in interpret mode (bf16) and backward_warp, at
  K3's tolerance 2^-8 (a bf16 input and a bf16 output each round by up
  to 2^-9); the plain float32 warps at 2e-5 (tests/test_torch_warp.py).
- ingest_weights: tests/test_ingest.py's cases through the port's tool,
  and both tools install a file under the same name.
- bench_matrix: every suite's rows at a tiny ladder on --device cpu, as
  tests/test_torch_bench_e2e.py runs its bench.
- mint_lpips: the initial weights and the six distortion families equal
  the JAX tool's (the same numpy and cv2 calls, atol 1e-5); the distance
  at rtol 1e-5; one step's ranking loss at rel 1e-5 and its gradient
  leaves at ||port - jax|| / ||jax|| <= 1e-4 (tests/test_torch_train.py);
  the schedule and the clip against optax; the ranking gate on stub
  distances; the written pair loads through train/metrics.LPIPS, nothing
  ships when the gate refuses, and the committed pair stays as it is.
- the surface: every name that the JAX package's ops, train, models,
  parallel and upscale export is importable from the port's counterpart,
  and every public top-level name of the JAX package's modules (but its
  Pallas kernels) has one, save the allow-list below.
"""

import ast
import hashlib
import importlib
import os
import sys
from fractions import Fraction
from math import gcd
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sharkshark_tpu.ops import backward_warp as jbackward_warp
from sharkshark_tpu.ops.pallas.warp_band import WINDOW_FULL, banded_backward_warp, banded_warp_bases
from sharkshark_tpu_torch.tools import bench_matrix, ingest_weights, mint_lpips, warp_fidelity
from sharkshark_tpu_torch.train.metrics import LPIPS
from sharkshark_tpu_torch.upscale import levels
from sharkshark_tpu_torch.upscale import service as service_mod

ROOT = Path(__file__).resolve().parent.parent
MINTED = ROOT / "weights" / "minted"
K3_TOL = 2.0**-8
sys.path.insert(0, str(ROOT / "tools"))


def _jax_tool(name):
    return importlib.import_module(name)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ warp_fidelity


@pytest.mark.parametrize("disp", [4.0, 20.0, 90.0])
def test_warp_fidelity_matches_the_jax_kernel_and_gather(disp):
    h, w, cells = 64, 128, 32
    rng = np.random.default_rng(int(disp))
    coarse = rng.uniform(-1.0, 1.0, (1, h // cells, w // cells, 2)).astype(np.float32)
    x = warp_fidelity.load_image(None, h, w).astype(np.float32)[None] / 255.0
    flow = warp_fidelity.smooth_flow(torch.from_numpy(coarse), h, w, disp)
    jflow = (jax.image.resize(jnp.asarray(coarse), (1, h, w, 2), "bilinear") * disp).astype(jnp.float32)
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), rtol=0, atol=1e-5 * disp)
    got, ref = warp_fidelity.warp_pair(torch.from_numpy(x), flow)
    bx, by, ok_fast, _ = banded_warp_bases(jflow)
    kw = {} if bool(ok_fast) else {"window": WINDOW_FULL}
    jgot = np.asarray(banded_backward_warp(jnp.asarray(x), jflow, bx, by, compute_dtype=jnp.bfloat16,
                                           interpret=True, **kw), np.float32)
    jref = np.asarray(jbackward_warp(jnp.asarray(x), jflow))
    np.testing.assert_allclose(ref.numpy(), jref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), jref, rtol=0, atol=K3_TOL)
    np.testing.assert_allclose(got.numpy(), jgot, rtol=0, atol=K3_TOL)


def test_warp_fidelity_rows(capsys):
    rows = warp_fidelity.run(["--size", "64", "128", "--device", "cpu"])
    assert [r["disp_px"] for r in rows] == [4.0, 20.0, 90.0]
    for r in rows:
        assert set(r) == {"disp_px", "window", "psnr_db", "max_abs_err"} and r["window"] == "single"
        assert r["max_abs_err"] <= K3_TOL and r["psnr_db"] > 45.0
    assert '{"warp_fidelity": ' in capsys.readouterr().out.splitlines()[-1]


def test_warp_fidelity_coarse_field_is_seeded_by_the_magnitude():
    a, b = warp_fidelity.coarse_field(64, 128, 32, 20.0), warp_fidelity.coarse_field(64, 128, 32, 20.0)
    assert torch.equal(a, b) and a.shape == (1, 2, 4, 2) and float(a.abs().max()) <= 1.0
    assert not torch.equal(a, warp_fidelity.coarse_field(64, 128, 32, 4.0))


# ------------------------------------------------------------ ingest_weights

FIXTURES = [
    ("realesr-general-x4v3", "srvgg-derived-x4.pth", "realesr-general-x4v3.pth"),
    ("bsvd-32", "bsvd-derived-32.pth", "bsvd-32.pth"),
    ("egvsr", "egvsr-derived-x4.pth", "EGVSR_iter420000.pth"),
]


def _ingest(path, model, wdir):
    return ingest_weights.main([str(path), "--model", model, "--weight-dir", str(wdir), "--device", "cpu"])


@pytest.mark.parametrize("model,fixture,canonical", FIXTURES)
def test_ingest_installs_canonical(tmp_path, model, fixture, canonical):
    src = MINTED / fixture
    dst = _ingest(src, model, tmp_path / "weights")
    assert Path(dst) == tmp_path / "weights" / canonical
    assert Path(dst).read_bytes() == src.read_bytes()


@pytest.mark.parametrize("model,fixture,canonical", FIXTURES)
def test_both_tools_install_the_same_name(tmp_path, monkeypatch, model, fixture, canonical):
    src = MINTED / fixture
    jtool = _jax_tool("ingest_weights")
    monkeypatch.setattr(sys, "argv", ["ingest_weights.py", str(src), "--model", model,
                                      "--weight-dir", str(tmp_path / "jax")])
    jtool.main()
    _ingest(src, model, tmp_path / "port")
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port")) == [canonical]


def test_ingest_zoo_keeps_release_basename(tmp_path):
    staged = tmp_path / "realesr-general-wdn-x4v3.pth"
    staged.write_bytes((MINTED / "srvgg-derived-x4.pth").read_bytes())
    _ingest(staged, "realesr-general-x4v3", tmp_path / "weights")
    assert (tmp_path / "weights" / "realesr-general-wdn-x4v3.pth").exists()


def _inner(sd):
    return sd["params"] if isinstance(sd, dict) and "params" in sd else sd


@pytest.mark.parametrize("model,fixture", [f[:2] for f in FIXTURES])
def test_ingest_rejects_missing_key(tmp_path, model, fixture):
    sd = torch.load(MINTED / fixture, map_location="cpu", weights_only=True)
    inner = _inner(sd)
    del inner[sorted(k for k in inner if k.endswith("weight"))[0]]
    bad = tmp_path / "bad.pth"
    torch.save(sd, str(bad))
    with pytest.raises((KeyError, ValueError, SystemExit)):
        _ingest(bad, model, tmp_path / "weights")
    assert not (tmp_path / "weights").exists()


def test_ingest_rejects_misshaped_key(tmp_path):
    sd = torch.load(MINTED / "srvgg-derived-x4.pth", map_location="cpu", weights_only=True)
    inner = _inner(sd)
    k = sorted(inner)[0]
    inner[k] = torch.zeros(tuple(np.array(inner[k].shape) + 1))
    bad = tmp_path / "bad.pth"
    torch.save(sd, str(bad))
    with pytest.raises(ValueError, match="shape"):
        _ingest(bad, "realesr-general-x4v3", tmp_path / "weights")
    assert not (tmp_path / "weights").exists()


def test_ingest_unknown_model_exits(tmp_path):
    with pytest.raises(SystemExit):
        _ingest(MINTED / "srvgg-derived-x4.pth", "nope", tmp_path / "w")
    assert not (tmp_path / "w").exists()


def test_ingest_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ingest_weights.main([str(MINTED / "srvgg-derived-x4.pth"), "--model", "realesr-general-x4v3",
                             "--weight-dir", "unused"])


# ------------------------------------------------------------ bench_matrix

LR, OUT = (16, 32), (32, 64)


@pytest.fixture
def tiny_ladder(monkeypatch):
    monkeypatch.setattr(service_mod, "LR_LEVELS", (LR,) * 6)
    monkeypatch.setattr(levels, "LR_LEVELS", (LR,) * 6)
    monkeypatch.setattr(levels, "HR_LEVELS", (OUT,) * 3)


def test_bench_matrix_rows(tiny_ladder, capsys):
    rows = bench_matrix.run(["--configs", "3,0", "1,0", "--suites", "sr", "egvsr", "cuts", "denoise",
                             "--iters", "2", "--device", "cpu"])
    want = [
        {"lr_level", "hr_level", "lr", "out", "fused_epilogue", "fps"},
        {"lr_level", "hr_level", "lr", "out", "fused_epilogue", "fps"},
        *[{"model", "lr", "out", "ms_per_frame", "fps"}] * 3,
        *[{"model", "lr", "cut_every", "cut_skip", "ms_per_frame", "fps", "ms_p99_barrier"}] * 2,
        *[{"model", "lr", "window", "flow", "ms_per_frame"}] * 2,
        {"model", "lr", "out", "fps"},
    ]
    assert [set(r) - {"device", "card"} for r in rows] == want
    assert [r.get("model") for r in rows] == [None, None, "egvsr", "egvsr", "egvsr", "egvsr-cuts", "egvsr-cuts",
                                              "egvsr-warp-fast", "egvsr-warp-full", "realesrgan+bsvd"]
    for r in rows:
        assert r["device"] == "cpu" and r["card"] is None
        for k in ("fps", "ms_per_frame"):
            if k in r:
                assert np.isfinite(r[k]) and r[k] > 0, r
    assert rows[0]["fused_epilogue"] == "2/1" and [r["cut_skip"] for r in rows[5:7]] == [True, False]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith('{"matrix": ')


def _jax_tool_fused(lr, hr):
    """tools/bench_matrix.py's own choice of the fused epilogue."""
    if 4 * lr[0] * hr[1] == 4 * lr[1] * hr[0] and 4 * lr[0] >= hr[0]:
        f = Fraction(4 * lr[0], hr[0])
        period = 4 * f.denominator // gcd(f.numerator, 4 * f.denominator)
        if hr[0] % period == 0 and hr[1] % period == 0:
            return f"{f.numerator}/{f.denominator}"
    return None


@pytest.mark.parametrize("lr_level", range(6))
def test_bench_matrix_fused_epilogue_per_level(lr_level):
    for hr in levels.HR_LEVELS:
        lr = levels.LR_LEVELS[lr_level]
        assert bench_matrix.fused_ratio(lr, hr) == _jax_tool_fused(lr, hr), (lr, hr)


# ------------------------------------------------------------ mint_lpips


@pytest.fixture(scope="module")
def jmint():
    return _jax_tool("mint_lpips")


def _patch(seed=0, size=48):
    from sharkshark_tpu_torch.tools.make_derived_dataset import textured_still

    return textured_still(size, size, np.random.default_rng(seed)).astype(np.float32) / 255.0


def test_mint_init_params_equal_the_jax_tools(jmint):
    got, want = mint_lpips.init_params(3), jmint.init_params(3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", list(mint_lpips.DISTORTIONS))
def test_mint_distortion_families_match_the_jax_tool(jmint, name):
    x = _patch()
    for s in (0.15, 0.55, 0.95):
        got = mint_lpips.DISTORTIONS[name](x, s, np.random.default_rng(7))
        want = jmint.DISTORTIONS[name](x, s, np.random.default_rng(7))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"{name} {s}")


def test_mint_triplets_match_the_jax_tool(jmint):
    imgs = [_patch(i, 80) for i in range(3)]
    got = mint_lpips.sample_triplets(imgs, np.random.default_rng(5), 4, 32)
    want = jmint.sample_triplets(imgs, np.random.default_rng(5), 4, 32)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def _t_params(np_params):
    return {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in np_params.items()}


def _triplet():
    return mint_lpips.sample_triplets([_patch(i, 96) for i in range(3)], np.random.default_rng(1), 4, 64)


def test_mint_distance_matches_the_jax_tool(jmint):
    p = mint_lpips.init_params(0)
    ref, weak, strong = _triplet()
    got = mint_lpips.distance(_t_params(p), torch.from_numpy(ref), torch.from_numpy(strong))
    want = jmint.distance(jax.tree.map(jnp.asarray, p), jnp.asarray(ref), jnp.asarray(strong))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_mint_step_loss_and_gradients_match_jax(jmint):
    p = mint_lpips.init_params(0)
    ref, weak, strong = _triplet()
    tp = _t_params(p)
    loss, _ = mint_lpips.ranking_loss(tp, *(torch.from_numpy(a) for a in (ref, weak, strong)))
    grads = torch.autograd.grad(loss, list(tp.values()))

    def jloss(q, r, a, b):
        return jax.nn.softplus(jmint.distance(q, r, a) - jmint.distance(q, r, b) + 0.05).mean()

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, p), *(jnp.asarray(a) for a in (ref, weak, strong)))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k, g in zip(tp, grads):
        want = np.asarray(jg[k], np.float64)
        err = np.linalg.norm(g.numpy().astype(np.float64) - want)
        assert err <= 1e-4 * np.linalg.norm(want) + 1e-12, (k, err, np.linalg.norm(want))


def test_mint_schedule_and_clip_match_optax():
    sched, want = mint_lpips.cosine_decay(1e-3, 50), optax.cosine_decay_schedule(1e-3, 50, alpha=0.05)
    for count in (0, 1, 25, 49, 50, 80):
        np.testing.assert_allclose(sched(count), float(want(count)), rtol=1e-6)
    rng = np.random.default_rng(2)
    for scale in (0.1, 10.0):
        gs = [rng.standard_normal((3, 4)).astype(np.float32) * scale, rng.standard_normal(5).astype(np.float32) * scale]
        got = [torch.from_numpy(g.copy()) for g in gs]
        mint_lpips.clip_by_global_norm(got)
        clipped, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in gs], None)
        for a, b in zip(got, clipped):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_mint_export_loads_through_lpips(tmp_path):
    p = _t_params(mint_lpips.init_params(4))
    with torch.no_grad():
        p["lin2"][:5] = -1.0  # LPIPS clamps the calibration at 0, as the export does
    alex, lin = mint_lpips.export(p, str(tmp_path))
    ref, _, strong = (torch.from_numpy(a) for a in _triplet())
    with torch.no_grad():
        got = LPIPS(alex, lin, "cpu")(ref, strong)
        want = mint_lpips.distance(p, ref, strong)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)


def _digests():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(MINTED.glob("lpips-*.pth"))}


def _forced_check(monkeypatch, ok):
    """check_ranking as it runs, its verdict forced: on seeded stills after
    a few tens of steps the gate passes or fails with the run's rounding
    (the noise family saturates, the color family's gains are random)."""
    real = mint_lpips.check_ranking

    def check(model, hold):
        return {**real(model, hold), "ok": ok}

    monkeypatch.setattr(mint_lpips, "check_ranking", check)


def test_mint_lpips_ships_a_pair_lpips_loads(tmp_path, monkeypatch, capsys):
    _forced_check(monkeypatch, True)
    before = _digests()
    res = mint_lpips.main(["--steps", "8", "--batch", "4", "--out-dir", str(tmp_path / "out"), "--device", "cpu"])
    assert _digests() == before and len(before) == 2
    assert sorted(os.listdir(tmp_path / "out")) == ["lpips-alex-derived.pth", "lpips-lin-derived.pth"]
    assert len(res["losses"]) == 8 and all(np.isfinite(res["losses"]))
    out = capsys.readouterr().out
    for name in mint_lpips.DISTORTIONS:
        assert f"{name:10s} " in out
    model = LPIPS(str(tmp_path / "out" / "lpips-alex-derived.pth"), str(tmp_path / "out" / "lpips-lin-derived.pth"),
                  "cpu")
    x = torch.from_numpy(_patch(3, 64)[None] * 2 - 1)
    assert float(model(x, x)[0]) == 0.0 and float(model(x, -x)[0]) > 0.0


def test_mint_lpips_ships_nothing_the_check_refuses(tmp_path, monkeypatch):
    _forced_check(monkeypatch, False)
    with pytest.raises(SystemExit, match="not shipping"):
        mint_lpips.main(["--steps", "2", "--batch", "2", "--out-dir", str(tmp_path / "out"), "--device", "cpu"])
    assert not (tmp_path / "out").exists()


class _StubLPIPS:
    """The same five distances, by strength, for every family (the gate's
    5 calls a family), then the self-distance 0."""

    device = torch.device("cpu")

    def __init__(self, ds):
        self.ds, self.calls = ds, 0

    def __call__(self, a, b):
        n, self.calls = self.calls, self.calls + 1
        return torch.tensor([self.ds[n % 5] if n < 5 * len(mint_lpips.DISTORTIONS) else 0.0])


@pytest.mark.parametrize("ds,ok", [
    ([0.01, 0.02, 0.05, 0.1, 0.3], True),
    ([0.0, 0.02, 0.05, 0.1, 0.3], True),        # identity at the weakest strength
    ([0.2, 0.25, 0.3, 0.35, 0.39], False),      # ordered, but not twice the weakest
    ([0.05, 0.01, 0.1, 0.02, 0.3], False),      # rho below 0.9
    ([0.001, 0.002, 0.003, 0.004, 0.009], False),  # the strongest below 0.01
])
def test_mint_ranking_gate(ds, ok):
    check = mint_lpips.check_ranking(_StubLPIPS(ds), _patch(0, 160))
    assert check["ok"] is ok and all(f["ok"] is ok for f in check["families"].values())
    assert check["self_distance"] == 0.0


# ------------------------------------------------------------ the surface

# JAX names with no counterpart in the port, by design (ROADMAP.md §1) or
# queued for the next slice
ALLOWED = {
    "ops": {"conv2d_pairfold", "pairfold_conv_weights", "pixel_shuffle_folded_dil", "pixel_shuffle_mxu",
            "space_to_depth_mxu"},  # the MXU layouts of the TPU's convs
    "upscale": {"ShapeCache", "enable_persistent_cache"},  # upscale/jit_cache.py, the next slice
}
ALLOWED_MODULES = {
    "ops/lanefold.py": "the TPU's lane-folded convs",
    "upscale/jit_cache.py": "ShapeCache as per-shape CUDA graphs, the next slice",
}
ALLOWED_NAMES = {
    "ops/nn.py": ALLOWED["ops"],
    "train/datasets.py": {"log"},  # a module logger nothing logs through
    "train/metrics.py": {"log"},
}
PACKAGES = ("ops", "train", "models", "parallel", "upscale")


def _exported(pkg):
    tree = ast.parse((ROOT / "sharkshark_tpu" / pkg / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"sharkshark_tpu/{pkg}/__init__.py has no __all__")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_jax_package_export_has_a_counterpart(pkg):
    port = importlib.import_module(f"sharkshark_tpu_torch.{pkg}")
    missing = {n for n in _exported(pkg) if not hasattr(port, n)}
    assert missing == ALLOWED.get(pkg, set()), missing


def _public_names(path: Path) -> set[str]:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


JAX_MODULES = sorted(str(p.relative_to(ROOT / "sharkshark_tpu")) for p in (ROOT / "sharkshark_tpu").rglob("*.py")
                     if "pallas" not in p.parts and p.name != "__init__.py")


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_jax_module_name_has_a_counterpart(rel):
    port = ROOT / "sharkshark_tpu_torch" / rel
    if rel in ALLOWED_MODULES:
        assert not port.exists() or rel == "upscale/jit_cache.py", rel
        return
    assert port.exists(), f"sharkshark_tpu_torch/{rel} is missing"
    missing = _public_names(ROOT / "sharkshark_tpu" / rel) - _public_names(port)
    assert missing == ALLOWED_NAMES.get(rel, set()), missing
