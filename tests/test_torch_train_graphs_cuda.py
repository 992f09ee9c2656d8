"""The training driver's compiled steps on the card
(sharkshark_tpu_torch/train/compiled.py): each recipe's whole step
(forward, backward, Adam) captured into a CUDA graph per signature and
replayed, against the same step run eagerly.

- Under deterministic algorithms the graphed step equals the eager step
  bit for bit over six steps (a warm-up, a capture, four replays), for
  the VSR (FRNet), SISR (SRVGG), denoise (BSVD-32) and GAN recipes at a
  small size: every log, the parameters, Adam's moments, counts and
  rate, the step and the GAN's D decisions; a checkpoint loaded back
  into the graphed state keeps its graph, and the next replay equals the
  eager step from the same checkpoint.
- No gradient accumulates across replays: a batch whose loss has a zero
  gradient, replayed after steps with a nonzero one, leaves zero
  gradients and Adam's first moment decayed by beta1.
- The capturable Adam (its bias correction in float32 on the device)
  against the plain one (in float64 on the host) over 30 updates on
  identical gradients: the parameters apart by at most 1e-4 of the
  distance they moved.
- Test mode's inference replays its graph across calls, with K3 launched
  once a frame through the replays, and its output equal to the eager
  inference bit for bit; a training run's periodic tests share one
  inference graph.
- A body that reads the device on the host fails its capture, loudly.

These tests need an NVIDIA GPU (and nvcc for K3), so they carry the
`cuda` marker and skip on a host without CUDA.  On the card, without the
JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_train_graphs_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from sharkshark_tpu_torch.models import egvsr, srvgg
from sharkshark_tpu_torch.ops import warp as wp
from sharkshark_tpu_torch.train import checkpoint, compiled, denoise, driver, sisr, vsr, vsrgan
from sharkshark_tpu_torch.train import discriminators as D

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@contextlib.contextmanager
def deterministic():
    old = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old[1:]


def _rand(seed, dev, *shape):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32)).to(dev)


def _sched(k):
    return 1e-3 * 0.8**k


def _recipe(name, dev):
    """(a fresh state on `dev`, the recipe's eager step, six batches)."""
    if name == "vsr":
        cfg = vsr.VSRTrainConfig(model_cfg=egvsr.EGVSRConfig(nf=16, nb=2), lr=1e-3)
        return (lambda: vsr.create_train_state(torch.Generator().manual_seed(0), cfg, device=dev),
                vsr.make_train_step(cfg, _sched),
                [(_rand(i, dev, 2, 4, 16, 16, 3), _rand(10 + i, dev, 2, 4, 64, 64, 3)) for i in range(6)])
    if name == "sisr":
        cfg = sisr.SISRTrainConfig(model_cfg=srvgg.SRVGGConfig(num_feat=16, num_conv=4), lr=1e-3)
        return (lambda: sisr.create_sisr_state(torch.Generator().manual_seed(0), cfg, device=dev),
                sisr.make_sisr_train_step(cfg, _sched),
                [(_rand(20 + i, dev, 2, 2, 16, 16, 3), _rand(30 + i, dev, 2, 2, 64, 64, 3)) for i in range(6)])
    if name == "denoise":
        cfg = denoise.DenoiseTrainConfig(lr=1e-3)
        return (lambda: denoise.create_denoise_state(torch.Generator().manual_seed(0), cfg, device=dev),
                denoise.make_denoise_train_step(cfg, _sched),
                [(None, _rand(40 + i, dev, 1, 4, 32, 32, 3)) for i in range(6)])
    cfg = vsrgan.VSRGANConfig(model_cfg=egvsr.EGVSRConfig(nf=16, nb=1), disc_cfg=D.DiscriminatorConfig(spatial_size=32),
                              lr_g=1e-4, lr_d=1e-3, update_threshold=0.7)
    return (lambda: vsrgan.create_gan_state(torch.Generator().manual_seed(2), cfg, device=dev),
            vsrgan.make_gan_train_step(cfg),
            [(_rand(50 + i, dev, 2, 3, 8, 8, 3), _rand(60 + i, dev, 2, 3, 32, 32, 3)) for i in range(6)])


def _tensors(state) -> list:
    return [t.detach().clone() for t in compiled.state_tensors(state)]


def _assert_identical(a: list, b: list, what: str) -> None:
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), (what, i)


@pytest.mark.parametrize("name", ["vsr", "sisr", "denoise", "gan"])
def test_graphed_step_equals_the_eager_step_bit_for_bit(dev, name, tmp_path):
    make, step, batches = _recipe(name, dev)
    with deterministic():
        eager, graphed = make(), make()
        fn = compiled.TrainStepCache(step)
        for i, (lr, gt) in enumerate(batches):
            want = step(eager, lr, gt)[1]
            got = fn(graphed, lr, gt)[1]
            assert got.keys() == want.keys()
            for k in want:
                assert torch.equal(got[k], want[k]), (i, k)
        torch.cuda.synchronize()
        assert (fn.num_signatures, fn.num_graphs) == (1, 1)
        assert graphed.step == eager.step == len(batches)
        _assert_identical(_tensors(graphed), _tensors(eager), "state")
        if name == "gan":
            assert 0 < int(graphed.cnt_upd_d) == int(eager.cnt_upd_d) < len(batches)

        # the eager state's checkpoint loaded into the graphed state: the
        # graph stays, and its next replay is the eager step from there
        path = checkpoint.save_checkpoint(str(tmp_path), eager, eager.step)
        for lr, gt in batches[:2]:
            fn(graphed, lr, gt)
        where = [t.data_ptr() for t in compiled.state_tensors(graphed)]
        checkpoint.load_checkpoint(path, graphed)
        assert [t.data_ptr() for t in compiled.state_tensors(graphed)] == where
        fn(graphed, *batches[0])
        step(eager, *batches[0])
        assert (fn.num_signatures, fn.num_graphs) == (1, 1)
        _assert_identical(_tensors(graphed), _tensors(eager), "state after the load")


def test_no_gradient_accumulates_across_replays(dev):
    """loss = sum(w * x): after three steps on x = 1 (warm-up, capture,
    replay) a replay on x = 0 leaves zero gradients and exp_avg * beta1."""

    def body(state, x):
        vsr.optimizer_update(state.opt, (state.params["w"] * x).sum())
        return {}

    def prologue(state, x):
        vsr.set_rate(state.opt, 1e-2)
        return (x,)

    w = torch.ones(1000, device=dev, requires_grad=True)
    state = vsr.TrainState({"w": w}, vsr.make_optimizer([w], 1e-2, 0.9, 0.999))
    fn = compiled.TrainStepCache(compiled.eager_step(compiled.SplitStep(prologue, body, vsr.count_update)))
    for _ in range(3):
        fn(state, torch.ones(1000, device=dev))
    assert fn.num_graphs == 1 and torch.equal(w.grad, torch.ones_like(w))
    before = state.opt.state[w]["exp_avg"].clone()
    fn(state, torch.zeros(1000, device=dev))
    assert torch.equal(w.grad, torch.zeros_like(w))
    torch.testing.assert_close(state.opt.state[w]["exp_avg"], before * 0.9, rtol=1e-6, atol=0)
    assert float(state.opt.state[w]["step"]) == 4.0


def test_capturable_adam_against_the_plain_one(dev):
    """30 updates of a seeded FRNet's parameters on identical seeded
    gradients, at a rate that decays every step: the card's capturable
    Adam (vsr.make_optimizer) against torch.optim's plain one, the
    parameters apart by at most 1e-4 of the distance they moved.  (Whole
    training runs part much further: FRNet's recurrence grows the step's
    own float32 rounding, as it grows cuDNN's nondeterministic sums.)"""
    make, _, _ = _recipe("vsr", dev)
    leaves = vsr.param_leaves(make().params)
    a, b = ([p.detach().clone().requires_grad_(True) for p in leaves] for _ in range(2))
    cap = vsr.make_optimizer(a, 1e-3, 0.9, 0.999)
    plain = torch.optim.Adam(b, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    assert cap.param_groups[0]["capturable"] and not plain.param_groups[0]["capturable"]
    gen = torch.Generator(device=dev).manual_seed(5)
    for k in range(30):
        for x, y in zip(a, b):
            x.grad = torch.randn(x.shape, generator=gen, device=dev) * 1e-2
            y.grad = x.grad.clone()
        for opt in (cap, plain):
            vsr.set_rate(opt, _sched(k))
            opt.step()
    fa, fb, init = (torch.cat([p.detach().flatten() for p in x]) for x in (a, b, leaves))
    rel = float((fa - fb).norm() / (fb - init).norm())
    assert rel <= 1e-4, rel


def test_infer_graph_replays_with_k3_counted(dev):
    """FRNet's test-mode inference through a ShapeCache, as test() runs
    it: the first call eager, the second captured, the third replayed,
    each launching K3 once a frame; every output equal to the eager
    inference's."""
    opt = {"scale": 4, "model": {"generator": {"name": "FRNet", "nf": 16, "nb": 2}}}
    gen = driver.define_generator(opt, dev)
    params = gen["init"](torch.Generator().manual_seed(0))
    lr = _rand(70, dev, 5, 24, 40, 3)
    infer = driver.ShapeCache(gen["infer"])
    with torch.no_grad():
        want = gen["infer"](params, lr)
        for _ in range(3):
            before = wp.launches
            got = infer(params, lr)
            assert wp.launches - before == 5
            assert torch.equal(got, want)
    assert (infer.num_signatures, infer.num_graphs) == (1, 1)


def test_periodic_tests_replay_one_inference_graph(dev, tmp_path):
    """A tiny FRNet run (BD, three iterations, a test after each): the
    step and the periodic tests' inference each hold one graph, and the
    tests launch K3 once a frame, warm-up, capture and replay alike."""
    from sharkshark_tpu_torch.tools import make_derived_dataset as mdd

    mdd.write_stills(str(tmp_path / "stills"), 3, 64, seed=2)
    mdd.main(["--src", str(tmp_path / "stills"), "--out", str(tmp_path / "data"), "--holdout", "still_000.png",
              "--seqs", "4", "--tempo", "3", "--crop", "48", "--pan", "4", "--val-tempo", "3"])
    data = tmp_path / "data"
    opt = {
        "scale": 4, "manual_seed": 0,
        "dataset": {
            "degradation": {"type": "BD", "sigma": 1.5},
            "train": {"name": "Folder", "gt_seq_dir": str(data / "train" / "GT"),
                      "lr_seq_dir": str(data / "train" / "LR"), "crop_size": 32, "batch_size": 2, "num_workers": 0},
            "test1": {"gt_seq_dir": str(data / "val" / "GT"), "lr_seq_dir": str(data / "val" / "LR")},
        },
        "model": {"generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": 16, "nb": 1}},
        "train": {"tempo_extent": 3, "total_iter": 3, "ckpt_freq": 0, "ckpt_dir": str(tmp_path / "ckpt"),
                  "resume": False, "pixel_crit": {"type": "CB", "weight": 1},
                  "warping_crit": {"type": "CB", "weight": 1}, "generator": {"lr": 5e-5}},
        "test": {"test_freq": 1, "metrics": ["PSNR"], "psnr_colorspace": "y"},
        "logger": {"log_freq": 1},
    }
    before = wp.launches
    res = driver.train(opt, device=dev)
    assert res["iter"] == 3 and len(res["tests"]) == 3
    assert res["step_graphs"] == {"signatures": 1, "graphs": 1} == res["test_graphs"]
    assert wp.launches - before == 3 * 3


def test_a_host_read_in_the_body_fails_the_capture(dev):
    def body(state, x):
        loss = (state.params["w"] * x).sum()
        vsr.optimizer_update(state.opt, loss)
        if float(loss) > 0:  # a host read
            pass
        return {}

    w = torch.ones(8, device=dev, requires_grad=True)
    state = vsr.TrainState({"w": w}, vsr.make_optimizer([w], 1e-2, 0.9, 0.999))
    fn = compiled.TrainStepCache(compiled.eager_step(compiled.SplitStep(lambda s, x: (x,), body, vsr.count_update)))
    stream = torch.cuda.current_stream()
    fn(state, torch.ones(8, device=dev))  # the warm-up runs eagerly
    with pytest.raises(RuntimeError):
        fn(state, torch.ones(8, device=dev))
    assert fn.num_graphs == 0 and torch.cuda.current_stream() == stream
    # the card goes on working (this test runs last all the same)
    assert torch.equal(w.detach() * 0, torch.zeros(8, device=dev))
