"""The port's training data, metrics, checkpoints, FLOP count and driver
(sharkshark_tpu_torch/train: datasets, metrics with LPIPS, checkpoint,
model_summary, driver; tools/make_derived_dataset.py) against the JAX
package's, on the CPU, with the same inputs (numpy from a seed, the same
image folders, the same seeds for crops).

Tolerances: datasets, crops, the dataset tool's files and PSNR / tOF are
exact (the same numpy, cv2 and Python RNG calls); the BD degradation
atol 1e-6 (one depthwise conv); LPIPS atol 1e-5 on distances of order
0.1 (float32 convs summed in another order); the driver's test-mode PSNR
within 0.01 dB of the JAX driver's on the same weights (uint8 outputs
may differ by one level on a few pixels).
"""

import importlib.machinery
import json
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sharkshark_tpu.models import egvsr as jegvsr
from sharkshark_tpu.train import datasets as jdatasets
from sharkshark_tpu.train import driver as jdriver
from sharkshark_tpu.train import metrics as jmetrics
from sharkshark_tpu.train import model_summary as jmodel_summary
from sharkshark_tpu.utils import env as jenv
from sharkshark_tpu_torch.models import bsvd, egvsr
from sharkshark_tpu_torch.tools import make_derived_dataset as mdd
from sharkshark_tpu_torch.train import checkpoint, datasets, driver, metrics, model_summary, vsr
from sharkshark_tpu_torch.utils import env

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny shapes gain nothing from many CPU threads, and the test run's
    workers share the cores: two threads a worker keep them from
    oversubscribing."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

MINTED = os.path.join(ROOT, "weights", "minted")
TINY_G = egvsr.EGVSRConfig(nf=16, nb=1)
JTINY_G = jegvsr.EGVSRConfig(nf=16, nb=1)


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# ---------------------------------------------------------------- datasets


def test_bd_degradation_shapes():
    kernel = datasets.gaussian_downsample_kernel(sigma=1.5)
    assert kernel.shape == (9, 9, 1, 1)
    out = datasets.prepare_data(torch.ones((1, 2, 48, 48, 3)), kernel, scale=4, sigma=1.5)
    assert out["lr"].shape == (1, 2, 10, 10, 3)
    assert out["gt"].shape == (1, 2, 40, 40, 3)
    # a normalised kernel keeps a constant image's interior constant
    np.testing.assert_allclose(out["lr"][0, 0, 4, 4].numpy(), 1.0, rtol=1e-5)


def test_bd_degradation_matches_jax():
    kernel = datasets.gaussian_downsample_kernel(sigma=1.5)
    np.testing.assert_array_equal(kernel, jdatasets.gaussian_downsample_kernel(sigma=1.5))
    gt = _rand(0, 2, 2, 52, 44, 3)
    got = datasets.prepare_data(torch.from_numpy(gt), torch.from_numpy(kernel), scale=4, sigma=1.5)
    want = jdatasets.prepare_data(jnp.asarray(gt), kernel, scale=4, sigma=1.5)
    for k in ("lr", "gt"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6, err_msg=k)


def _write_seqs(root, n_seq=2, t=3, size=32, scale=4, seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    for split, s in (("gt", size), ("lr", size // scale)):
        for q in range(n_seq):
            d = root / split / f"seq{q:03d}"
            d.mkdir(parents=True)
            for i in range(t):
                cv2.imwrite(str(d / f"{i:04d}.png"), rng.integers(0, 256, (s, s, 3), dtype=np.uint8))
    return str(root / "gt"), str(root / "lr")


def test_paired_folder_dataset(tmp_path):
    import cv2

    for split, size in [("gt", 32), ("lr", 8)]:
        d = tmp_path / split / "seq000"
        d.mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(d / f"{i:04d}.png"), np.full((size, size, 3), i * 10, np.uint8))
    ds = datasets.PairedFolderDataset(str(tmp_path / "gt"), str(tmp_path / "lr"))
    assert len(ds) == 1
    s = ds[0]
    assert s["gt"].shape == (3, 32, 32, 3) and s["gt"].dtype == np.uint8
    assert s["lr"].shape == (3, 8, 8, 3) and s["lr"].dtype == np.float32
    batch = next(iter(datasets.create_dataloader(ds, batch_size=1, shuffle=False)))
    assert batch["gt"].shape == (1, 3, 32, 32, 3)


def test_train_dataset_crops_match_jax(tmp_path):
    """One seed: the same temporal windows, crops and flips as the JAX
    dataset, and a seeded loader's order is reproducible."""
    gt_dir, lr_dir = _write_seqs(tmp_path, n_seq=3, t=4)
    kw = dict(scale=4, crop_size=16, tempo_extent=3, seed=5)
    got = datasets.PairedFolderTrainDataset(gt_dir, lr_dir, **kw)
    want = jdatasets.PairedFolderTrainDataset(gt_dir, lr_dir, **kw)
    for i in [0, 1, 2, 1, 0, 2]:
        a, b = got[i], want[i]
        assert a["gt"].shape == (3, 16, 16, 3) and a["lr"].shape == (3, 4, 4, 3)
        np.testing.assert_array_equal(a["gt"], b["gt"])
        np.testing.assert_array_equal(a["lr"], b["lr"])

    def order(seed):
        ds = datasets.PairedFolderDataset(gt_dir, lr_dir)
        loader = datasets.create_dataloader(ds, batch_size=1, generator=torch.Generator().manual_seed(seed))
        return [b["seq_idx"][0] for b in loader]

    assert order(3) == order(3)
    assert sorted(order(3)) == ["seq000", "seq001", "seq002"]


class _FakeTxn:
    def __init__(self, store):
        self.store = store

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def get(self, key):
        return self.store.get(key)


def _fake_lmdb(stores):
    """An `lmdb` module whose open(path) serves stores[path] (key -> bytes)."""
    mod = types.ModuleType("lmdb")
    mod.__spec__ = importlib.machinery.ModuleSpec("lmdb", None)

    class Env:
        def __init__(self, path, **kw):
            self.store = stores[path]

        def begin(self, write=False):
            return _FakeTxn(self.store)

    mod.open = Env
    return mod


def _lmdb_dir(root, name, keys, frames):
    d = root / name
    d.mkdir()
    with open(d / "meta_info.pkl", "wb") as f:
        pickle.dump({"keys": keys}, f)
    return str(d), {k.encode("ascii"): v.tobytes() for k, v in frames.items()}


@pytest.fixture
def no_module_cache():
    env.has_module.cache_clear()
    jenv.has_module.cache_clear()
    yield
    env.has_module.cache_clear()
    jenv.has_module.cache_clear()


def test_lmdb_datasets_match_jax_with_a_stub_lmdb(tmp_path, monkeypatch, no_module_cache):
    """The lmdb package is absent here: a stub module stands in, serving
    one 5-frame 64x48 sequence (per-frame keys) and its 16x12 LR."""
    rng = np.random.default_rng(1)
    gt_frames = {f"0_64x48_5_{t:04d}": rng.integers(0, 256, (64, 48, 3), dtype=np.uint8) for t in range(5)}
    lr_frames = {f"0_16x12_5_{t:04d}": rng.integers(0, 256, (16, 12, 3), dtype=np.uint8) for t in range(5)}
    gt_path, gt_store = _lmdb_dir(tmp_path, "GT.lmdb", ["0_64x48_5"], gt_frames)
    lr_path, lr_store = _lmdb_dir(tmp_path, "LR.lmdb", ["0_16x12_5"], lr_frames)
    gt_store[b"0_64x48_5"] = gt_frames["0_64x48_5_0000"].tobytes()
    lr_store[b"0_16x12_5"] = lr_frames["0_16x12_5_0000"].tobytes()
    monkeypatch.setitem(sys.modules, "lmdb", _fake_lmdb({gt_path: gt_store, lr_path: lr_store}))

    for moving in (False, True):
        kw = dict(scale=4, crop_size=16, tempo_extent=3, moving_first_frame=moving, seed=7)
        got = datasets.PairedLMDBDataset(gt_path, lr_path, **kw)
        want = jdatasets.PairedLMDBDataset(gt_path, lr_path, **kw)
        for _ in range(3):
            a, b = got[0], want[0]
            assert a["gt"].shape == (3, 16, 16, 3) and a["lr"].shape == (3, 4, 4, 3)
            np.testing.assert_array_equal(a["gt"], b["gt"])
            np.testing.assert_array_equal(a["lr"], b["lr"])
    got = datasets.UnpairedLMDBDataset(gt_path, crop_size=24, tempo_extent=4, seed=2)
    want = jdatasets.UnpairedLMDBDataset(gt_path, crop_size=24, tempo_extent=4, seed=2)
    for _ in range(3):
        a = got[0]["gt"]
        assert a.shape == (4, 24, 24, 3)
        np.testing.assert_array_equal(a, want[0]["gt"])


def test_lmdb_dataset_without_lmdb_names_the_package(tmp_path, monkeypatch, no_module_cache):
    monkeypatch.setitem(sys.modules, "lmdb", None)  # import lmdb fails
    with pytest.raises(ImportError, match="lmdb"):
        datasets.UnpairedLMDBDataset(str(tmp_path))


def test_dataset_tool_writes_the_jax_tools_files(tmp_path, monkeypatch):
    """The port's copy of tools/make_derived_dataset.py writes the same
    files, byte for byte, as the JAX package's tool on the same stills."""
    stills = tmp_path / "stills"
    mdd.write_stills(str(stills), 3, 72, seed=4)
    args = ["--src", str(stills), "--holdout", "still_000.png", "--seqs", "3", "--tempo", "3",
            "--crop", "32", "--pan", "4", "--val-tempo", "3", "--noisy-sigma", "25"]
    mdd.main(args + ["--out", str(tmp_path / "port")])
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_derived_dataset as jmdd

    monkeypatch.setattr(sys, "argv", ["make_derived_dataset.py", *args, "--out", str(tmp_path / "jax")])
    jmdd.main()
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.png"))
    assert len(files) == 3 * 3 * 2 + 3 * 3
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
    assert files == sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))


# ----------------------------------------------------------------- metrics


def test_psnr_and_tof():
    img = np.random.RandomState(0).randint(0, 256, (32, 32, 3), np.uint8)
    assert metrics.compute_psnr(img, img, "rgb") == float("inf")
    noisy = np.clip(img.astype(int) + 5, 0, 255).astype(np.uint8)
    p = metrics.compute_psnr(img, noisy, "rgb")
    assert 30 < p < 40
    assert metrics.compute_psnr(img, noisy, "y") != p
    assert np.isfinite(metrics.compute_tof(img, img, noisy, noisy))


def test_psnr_tof_ycbcr_match_jax():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(metrics.rgb_to_ycbcr(a[0]), jmetrics.rgb_to_ycbcr(a[0]))
    for cs in ("y", "rgb"):
        assert metrics.compute_psnr(a[0], b[0], cs) == jmetrics.compute_psnr(a[0], b[0], cs)
    assert metrics.compute_tof(a[0], a[1], b[0], b[1]) == jmetrics.compute_tof(a[0], a[1], b[0], b[1])


def test_metric_calculator_aggregation(tmp_path):
    calc = metrics.MetricCalculator(metrics=["PSNR", "tOF"])
    seq = np.random.RandomState(0).randint(0, 256, (3, 16, 16, 3), np.uint8)
    calc.compute_sequence_metrics("seq0", seq, seq)
    avg = calc.average()
    assert avg["PSNR"] == float("inf") and avg["tOF"] == 0.0
    path = str(tmp_path / "m.json")
    calc.save(path, "test")
    assert os.path.exists(path)


def test_metric_calculator_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    gt = rng.integers(0, 256, (3, 24, 32, 3), dtype=np.uint8)
    pred = np.clip(gt.astype(int) + rng.integers(-12, 13, gt.shape), 0, 255).astype(np.uint8)
    got = metrics.MetricCalculator(metrics=["PSNR", "tOF"])
    want = jmetrics.MetricCalculator(metrics=["PSNR", "tOF"])
    for calc in (got, want):
        calc.compute_sequence_metrics("a", gt, pred)
        calc.compute_sequence_metrics("b", gt[::-1], pred[::-1])
    assert got.average() == want.average()
    got.save(str(tmp_path / "p.json"), "x")
    want.save(str(tmp_path / "j.json"), "x")
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads((tmp_path / "j.json").read_text())


# ---------------------------------------------------------------- LPIPS

# torchvision alexnet .features conv shapes: (out, in, kh, kw), stride, pad
_ALEX_SPECS = {
    0: ((64, 3, 11, 11), 4, 2),
    3: ((192, 64, 5, 5), 1, 2),
    6: ((384, 192, 3, 3), 1, 1),
    8: ((256, 384, 3, 3), 1, 1),
    10: ((256, 256, 3, 3), 1, 1),
}


def _synthetic_alexnet(tmp_path):
    rng = np.random.default_rng(11)
    sd = {}
    for i, (shape, _, _) in _ALEX_SPECS.items():
        sd[f"features.{i}.weight"] = torch.from_numpy((rng.normal(size=shape) * 0.05).astype(np.float32))
        sd[f"features.{i}.bias"] = torch.from_numpy((rng.normal(size=shape[0]) * 0.01).astype(np.float32))
    path = str(tmp_path / "alexnet_synth.pth")
    torch.save(sd, path)
    return path, sd


def _torch_lpips(sd, lin_sd, img0, img1):
    """Independent PNetLin on NCHW: scale -> conv/relu/pool taps ->
    unit-norm -> squared diff -> clamped 1x1 lin -> spatial mean -> sum."""
    shift = torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1)
    scale = torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)

    def feats(x):
        x = (x - shift) / scale
        taps = []
        for i, (_, stride, pad) in _ALEX_SPECS.items():
            x = F.relu(F.conv2d(x, sd[f"features.{i}.weight"], sd[f"features.{i}.bias"], stride=stride, padding=pad))
            taps.append(x)
            if i in (0, 3):
                x = F.max_pool2d(x, 3, 2)
        return taps

    total = 0.0
    for k, (a, b) in enumerate(zip(feats(img0), feats(img1))):
        a = a / (a.norm(dim=1, keepdim=True) + 1e-10)
        b = b / (b.norm(dim=1, keepdim=True) + 1e-10)
        total = total + F.conv2d((a - b) ** 2, lin_sd[f"lin{k}.model.1.weight"].clamp(min=0)).mean(dim=(2, 3))[:, 0]
    return total


def _pair(seed, n=2, size=64):
    rng = np.random.default_rng(seed)
    img0 = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(0, 0.1, img0.shape), -1, 1).astype(np.float32)
    return img0, img1


def test_minted_lin_weights_parse():
    lin = torch.load(metrics.MINTED_LIN_PATH, map_location="cpu", weights_only=True)
    for k, c in enumerate((64, 192, 384, 256, 256)):
        assert tuple(lin[f"lin{k}.model.1.weight"].shape) == (1, c, 1, 1)


def test_lpips_matches_independent_torch_formula(tmp_path):
    alex_path, sd = _synthetic_alexnet(tmp_path)
    model = metrics.LPIPS(alex_path, metrics.MINTED_LIN_PATH, device="cpu")
    assert model.provenance == "ingested"
    img0, img1 = _pair(3)
    got = model(torch.from_numpy(img0), torch.from_numpy(img1)).numpy()
    lin_sd = torch.load(metrics.MINTED_LIN_PATH, map_location="cpu", weights_only=True)
    want = _torch_lpips(sd, lin_sd, torch.from_numpy(img0.transpose(0, 3, 1, 2)),
                        torch.from_numpy(img1.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-6)
    zero = model(torch.from_numpy(img0), torch.from_numpy(img0)).numpy()
    assert np.all(zero < 1e-6) and np.all(got > zero + 1e-6)


def test_minted_lpips_matches_jax():
    img0, img1 = _pair(4, n=3, size=72)
    got = metrics.LPIPS.minted("cpu")(torch.from_numpy(img0), torch.from_numpy(img1)).numpy()
    want = np.asarray(jmetrics.LPIPS.minted()(jnp.asarray(img0), jnp.asarray(img1)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_minted_lpips_loads_and_ranks_distortions():
    import cv2

    model = metrics.LPIPS.minted("cpu")
    rng = np.random.default_rng(7)
    base = cv2.GaussianBlur(rng.uniform(0, 1, (96, 96, 3)).astype(np.float32), (0, 0), 4)[None]
    ds = []
    for sigma in (0.02, 0.08, 0.2):
        noisy = np.clip(base + rng.normal(0, sigma, base.shape), 0, 1).astype(np.float32)
        ds.append(float(model(torch.from_numpy(base * 2 - 1), torch.from_numpy(noisy * 2 - 1))[0]))
    assert ds[0] < ds[1] < ds[2], ds
    assert float(model(torch.from_numpy(base * 2 - 1), torch.from_numpy(base * 2 - 1))[0]) < 1e-6


def test_metric_calculator_lpips_out_of_box():
    calc = metrics.MetricCalculator(metrics=["PSNR", "LPIPS"], lpips=metrics.LPIPS.minted("cpu"))
    rng = np.random.default_rng(5)
    gt = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    pred = np.clip(gt.astype(np.int16) + rng.integers(-20, 21, gt.shape), 0, 255).astype(np.uint8)
    res = calc.compute_sequence_metrics("seq0", gt, pred)
    assert np.isfinite(res["PSNR"]) and np.isfinite(res["LPIPS"]) and res["LPIPS"] > 0
    want = jmetrics.MetricCalculator(metrics=["PSNR", "LPIPS"], lpips=jmetrics.LPIPS.minted())
    np.testing.assert_allclose(res["LPIPS"], want.compute_sequence_metrics("seq0", gt, pred)["LPIPS"], atol=1e-5)
    assert calc.compute_sequence_metrics("seq1", gt, gt)["LPIPS"] < 1e-6


def test_metric_json_stamps_lpips_provenance(tmp_path):
    lp = metrics.LPIPS.minted("cpu")
    assert lp.provenance == "minted"
    calc = metrics.MetricCalculator(metrics=["LPIPS"], lpips=lp)
    gt = np.random.default_rng(5).integers(0, 256, (1, 48, 48, 3), dtype=np.uint8)
    calc.compute_sequence_metrics("seq0", gt, gt)
    path = str(tmp_path / "test_avg.json")
    calc.save(path, "iter 1")
    assert json.loads(open(path).read())["iter 1"]["lpips_weights"] == "minted"
    calc2 = metrics.MetricCalculator(metrics=["PSNR"])
    calc2.compute_sequence_metrics("seq0", gt, gt)
    calc2.save(path, "iter 2")
    assert "lpips_weights" not in json.loads(open(path).read())["iter 2"]


# ------------------------------------------------- checkpoint, FLOP count


def test_checkpoint_roundtrip(tmp_path):
    cfg = vsr.VSRTrainConfig(model_cfg=TINY_G)
    state = vsr.create_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    path = checkpoint.save_checkpoint(str(tmp_path), state, 7)
    assert checkpoint.latest_checkpoint(str(tmp_path)) == path
    restored = checkpoint.load_checkpoint(path, vsr.create_train_state(torch.Generator().manual_seed(1), cfg,
                                                                       device="cpu"))
    torch.testing.assert_close(restored.params["srnet"]["conv_in"]["w"], state.params["srnet"]["conv_in"]["w"],
                               rtol=0, atol=0)
    # names order as the JAX package's do
    checkpoint.save_checkpoint(str(tmp_path), state, 12)
    assert os.path.basename(checkpoint.latest_checkpoint(str(tmp_path))) == "ckpt_000000012"


def test_profile_model_reports_flops():
    """FlopCounterMode counts every tap of a padded conv; XLA's cost
    analysis only the taps inside the image, and elementwise work too: at
    64x64, where the borders are a few percent of the pixels, the port's
    count is within 5 % above the JAX package's."""
    params = egvsr.init_params(torch.Generator().manual_seed(0), TINY_G)
    jparams = jax.tree.map(lambda a: jnp.asarray(a.numpy()), params)

    def fwd(p, x):
        return egvsr.infer_sequence(p, x, cfg=TINY_G)

    got = model_summary.profile_model(fwd, params, torch.zeros((1, 1, 64, 64, 3)))["flops"]
    want = jmodel_summary.profile_model(lambda p, x: jegvsr.infer_sequence(p, x, cfg=JTINY_G), jparams,
                                        jnp.zeros((1, 1, 64, 64, 3)))["flops"]
    assert want <= got <= 1.05 * want, (got, want)
    assert model_summary.count_params(params) == jmodel_summary.count_params(jparams) > 1000
    assert model_summary.benchmark_fps(fwd, params, torch.zeros((1, 1, 16, 16, 3)), iters=2) > 0


# ------------------------------------------------------------------ driver


@pytest.fixture(scope="module")
def derived(tmp_path_factory):
    """A tiny derived dataset: 4 panned 3-frame sequences of 32x32 GT
    (8x8 LR) from seeded stills, a 3-frame 32x32 val sequence and its
    noisy copy (sigma 25)."""
    root = tmp_path_factory.mktemp("derived")
    mdd.write_stills(str(root / "stills"), 3, 64, seed=1)
    mdd.main(["--src", str(root / "stills"), "--out", str(root / "data"), "--holdout", "still_000.png",
              "--seqs", "4", "--tempo", "3", "--crop", "32", "--pan", "4", "--val-tempo", "3",
              "--noisy-sigma", "25"])
    return root


def _config(root, name, **gen):
    data = root / "data"
    denoise = name == "bsvd"
    return {
        "scale": 1 if denoise else 4,
        "manual_seed": 0,
        "model": {"generator": {"name": name, **gen}},
        "dataset": {
            "degradation": {"type": "BI"},
            "train": {"name": "Folder", "gt_seq_dir": str(data / "train" / "GT"),
                      "lr_seq_dir": str(data / "train" / ("GT" if denoise else "LR")),
                      "crop_size": 16 if denoise else 32, "batch_size": 2, "num_workers": 0},
            "test": {"gt_seq_dir": str(data / "val" / "GT"),
                     "lr_seq_dir": str(data / "val" / ("noisy" if denoise else "LR"))},
        },
        "train": {"tempo_extent": 3, "total_iter": 3, "ckpt_freq": 2, "ckpt_dir": str(root / f"ckpt_{name}"),
                  "resume": True, "generator": {"lr": 1e-3, "lr_schedule": {
                      "type": "CosineAnnealingLR_Restart", "periods": [3], "restart_weights": [1.0],
                      "eta_min": 1e-4}},
                  "pixel_crit": {"type": "CB", "weight": 1.0}},
        "test": {"test_freq": 3, "metrics": ["PSNR"], "psnr_colorspace": "y", "profile_size": [16, 16],
                 "noise_sigma": 25, "json_dir": str(root / f"json_{name}")},
        "logger": {"log_freq": 1},
    }


def _write(path, opt):
    import yaml

    path.write_text(yaml.safe_dump(opt))
    return str(path)


@pytest.mark.parametrize("name,gen", [("FRNet", {"nf": 16, "nb": 2}), ("srvgg", {"nf": 8, "num_conv": 2}),
                                      ("BSVD", {"variant": 32})])
def test_driver_train_test_profile_on_the_cpu(derived, name, gen):
    """main(--mode train) for 3 iterations (a checkpoint at 2, the
    periodic test at 3), then again to 5 from the newest checkpoint;
    --mode test from the run's checkpoints; --mode profile."""
    opt = _config(derived, name.lower(), **gen)
    cfg = _write(derived / f"{name}.yml", opt)
    res = driver.main(["--config", cfg, "--mode", "train", "--device", "cpu"])
    assert res["iter"] == 3 and res["resumed_from"] is None and len(res["losses"]) == 3
    assert all(np.isfinite(res["losses"]))
    assert [os.path.basename(p) for p in res["checkpoints"]] == ["ckpt_000000002", "ckpt_000000003"]
    assert np.isfinite(res["tests"]["iter_3"]["test"]["PSNR"])
    assert "iter_3" in json.loads((derived / f"json_{name.lower()}" / "test_avg.json").read_text())

    opt["train"]["total_iter"] = 5
    res = driver.main(["--config", _write(derived / f"{name}.yml", opt), "--mode", "train", "--device", "cpu"])
    assert os.path.basename(res["resumed_from"]) == "ckpt_000000003"
    assert res["iter"] == 5 and len(res["losses"]) == 2

    opt["model"]["generator"]["load_path"] = opt["train"]["ckpt_dir"]
    res = driver.main(["--config", _write(derived / f"{name}.yml", opt), "--mode", "test", "--device", "cpu"])
    assert np.isfinite(res["test"]["PSNR"])
    stats = driver.main(["--config", cfg, "--mode", "profile", "--device", "cpu"])
    assert stats["flops"] > 0 and stats["params"] > 0 and stats["fps"] > 0 and stats["device"] == "cpu"


def test_driver_test_mode_matches_the_jax_driver(derived, tmp_path):
    """--mode test with the minted EGVSR .pth: the port's PSNR and saved
    frames against the JAX driver's test() on the same config."""
    opt = _config(derived, "frnet", nf=64, nb=10, load_path=os.path.join(MINTED, "egvsr-derived-x4.pth"))
    opt["test"].update(res_dir=str(tmp_path / "port"), json_dir=None)
    got = driver.main(["--config", _write(tmp_path / "c.yml", opt), "--mode", "test", "--device", "cpu"])
    opt["test"]["res_dir"] = str(tmp_path / "jax")
    want = jdriver.test(opt)
    assert abs(got["test"]["PSNR"] - want["test"]["PSNR"]) <= 0.01, (got, want)
    import cv2

    frames = sorted((tmp_path / "port" / "test").rglob("*.png"))
    assert len(frames) == 3
    for f in frames:
        a = cv2.imread(str(f)).astype(int)
        b = cv2.imread(str(tmp_path / "jax" / f.relative_to(tmp_path / "port"))).astype(int)
        assert np.abs(a - b).max() <= 1


def test_driver_refuses_what_is_not_ported(derived):
    """Every generator name is ported: BSVD-64 (`variant: 64`) builds, as
    do a GAN config and the espnet / vespnet / sofnet generators; the
    variants have no training recipe (the JAX driver trains FRNet under
    their names) and say so."""
    assert driver.define_generator(_config(derived, "bsvd", variant=64), device="cpu")["cfg"] == bsvd.BSVD_64
    assert driver.build_training(_config(derived, "bsvd", variant=64), device="cpu").cfg.model_cfg == bsvd.BSVD_64
    opt = _config(derived, "frnet", nf=16, nb=2)
    opt["model"]["discriminator"] = {"name": "STNet"}
    assert type(driver.build_training(opt, device="cpu").state).__name__ == "GANTrainState"
    for name in ("espnet", "vespnet", "sofnet"):
        assert driver.define_generator(_config(derived, name), device="cpu")["name"] == name
        with pytest.raises(ValueError, match="no training recipe"):
            driver.build_training(_config(derived, name), device="cpu")


def test_driver_runs_on_the_card_by_default(derived):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would run there")
    cfg = _write(derived / "frnet_default.yml", _config(derived, "frnet", nf=16, nb=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.main(["--config", cfg, "--mode", "profile"])
