"""The training driver's steps compiled per input signature
(sharkshark_tpu_torch/train/compiled.py, the counterpart of the JAX
driver's jax.jit of each step), on the CPU, where a compiled step runs
its body eagerly and nothing is captured.

- Each recipe's step, split into a host prologue, a device body and a
  host epilogue, equals the step as it was before the split (rebuilt
  here from the recipes' own parts: loss, back-propagation, the rate set
  after it, the optimizer step, the count; for the GAN, its D decision
  read on the host) bit for bit over several steps: parameters, Adam's
  moments and counts, logs, state.step and the D updates.  So does the
  driver's compiled step.
- The GAN step with its D decision on the device equals the JAX step
  (sharkshark_tpu/train/vsrgan.py) over five steps under a threshold
  that updates D on some and skips it on others, at
  tests/test_torch_gan.py's tolerances for more than one step (moments
  1e-3 leaf by leaf, updates 1e-2, the D decisions and counts equal),
  and the host-read route bit for bit.
- The rate each step's update uses is sched(state.step), filled into a
  tensor rate in place.
- The driver routes every step, the BD degradation and test mode's
  inference through their caches (signatures counted), and profile
  mode's timing through a ShapeCache.
- A checkpoint loads into the state's own tensors, so a step compiled
  before the load keeps its signature and gives the straight run's next
  step, bit for bit.
- The cache's life cycle (first call of a signature eager, second
  captured, later ones replayed, MAX_GRAPHS at most) with the device's
  warm-up, capture and replay stood in for.

tests/test_torch_train_graphs_cuda.py holds the graphs themselves on the
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.train import vsrgan as jvsrgan
from sharkshark_tpu_torch.models import egvsr, srvgg
from sharkshark_tpu_torch.train import checkpoint, compiled, denoise, driver, sisr, vsr, vsrgan
from sharkshark_tpu_torch.upscale import jit_cache
from test_torch_gan import SIZE, _assert_moments_close, _assert_updates_close, _gan_cfgs, _jax_state, _seeded_pair


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny shapes gain nothing from many CPU threads, and the test run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


STEPS = 4


def _rand(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def _sched(k):
    """A rate that differs at every step."""
    return 1e-3 * 0.7**k


# -------------------------------------------------------- the steps before the split


def _old_apply(state, loss, sched):
    """vsr.apply_gradients before the split: back-propagate, then the rate
    at the current count, the optimizer step, the count."""
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    lr = sched(state.step)
    for group in state.opt.param_groups:
        group["lr"] = lr
    state.opt.step()
    state.step += 1


def _old_step(loss_fn, sched, noise_cfg=None):
    def step(state, lr_data, gt_data):
        sigma = None
        if noise_cfg is not None:
            lr_data, sigma = denoise.noisy_input(noise_cfg, gt_data, state.step)
        loss, logs = loss_fn(state.params, lr_data, gt_data)
        _old_apply(state, loss, sched)
        logs = {k: v.detach() for k, v in logs.items()}
        if sigma is not None:
            logs["sigma_mean"] = sigma.mean()
        return state, logs

    return step


def _old_gan_step(cfg):
    """The GAN step before the split: the D decision read on the host, D's
    optimizer not stepped on a skip; its D count kept in `counts`."""
    losses = vsrgan.make_gan_loss_fns(cfg)
    adaptive = cfg.update_policy == "adaptive"
    counts = {}

    def step(state, lr_data, gt_data):
        ctx = losses.prepare(state.params_g, lr_data, gt_data)
        d_leaves = vsr.param_leaves(state.params_d)
        loss_d, aux = losses.d_loss(state.params_d, ctx)
        grads_d = torch.autograd.grad(loss_d, d_leaves, allow_unused=True)
        upd_d = not adaptive or bool(aux["distance"] < cfg.update_threshold)
        if upd_d:
            vsrgan._update(state.opt_d, d_leaves, grads_d)
        g_leaves = vsr.param_leaves(state.params_g)
        loss_g, logs = losses.g_loss(state.params_g, state.params_d, ctx, aux)
        grads_g = torch.autograd.grad(loss_g, g_leaves, allow_unused=True)
        vsrgan._update(state.opt_g, g_leaves, grads_g)
        logs.update(l_gan_D=loss_d if upd_d else torch.zeros_like(loss_d), p_real_D=aux["real_logits"].mean(),
                    p_fake_D=aux["fake_logits"].mean(), distance=aux["distance"])
        state.step += 1
        counts[id(state)] = counts.get(id(state), 0) + int(upd_d)
        return state, {k: v.detach() for k, v in logs.items()}

    step.counts = counts
    return step


def _gan_batches(n, seed=50):
    return [(_rand(seed + i, 2, 3, SIZE // 4, SIZE // 4, 3), _rand(seed + 10 + i, 2, 3, SIZE, SIZE, 3))
            for i in range(n)]


def _case(name):
    """(make a fresh state, the step as it was, the split step, batches)."""
    if name == "vsr":
        cfg = vsr.VSRTrainConfig(model_cfg=egvsr.EGVSRConfig(nf=16, nb=1), lr=1e-3)
        return (lambda: vsr.create_train_state(torch.Generator().manual_seed(0), cfg, device="cpu"),
                _old_step(vsr.make_loss_fn(cfg), _sched), vsr.make_train_step(cfg, _sched),
                [(_rand(10 + i, 2, 3, 8, 8, 3), _rand(20 + i, 2, 3, 32, 32, 3)) for i in range(STEPS)])
    if name == "sisr":
        cfg = sisr.SISRTrainConfig(model_cfg=srvgg.SRVGGConfig(num_feat=8, num_conv=2), lr=1e-3)
        return (lambda: sisr.create_sisr_state(torch.Generator().manual_seed(0), cfg, device="cpu"),
                _old_step(sisr.make_sisr_loss_fn(cfg), _sched), sisr.make_sisr_train_step(cfg, _sched),
                [(_rand(30 + i, 2, 1, 8, 8, 3), _rand(40 + i, 2, 1, 32, 32, 3)) for i in range(STEPS)])
    if name == "denoise":
        cfg = denoise.DenoiseTrainConfig(lr=1e-3)
        return (lambda: denoise.create_denoise_state(torch.Generator().manual_seed(0), cfg, device="cpu"),
                _old_step(denoise.make_denoise_loss_fn(cfg), _sched, noise_cfg=cfg),
                denoise.make_denoise_train_step(cfg, _sched),
                [(None, _rand(50 + i, 1, 3, 16, 16, 3)) for i in range(STEPS)])
    # the GAN: thresholds under which these five steps update D and skip it
    # (0.3: update, skip, skip, update, skip; 0.7: update, update, skip,
    # update, skip; every distance 0.05 or more from the threshold), a D
    # never updated (its plain Adam's state made and dropped), and 'always'
    over = {"gan_0.3": dict(update_threshold=0.3), "gan_0.7": dict(update_threshold=0.7),
            "gan_skip": dict(update_threshold=-1e9), "gan_always": dict(update_policy="always")}[name]
    cfg, jcfg = _gan_cfgs(lr_g=1e-3, lr_d=1e-3, **over)
    gp, dp = _seeded_pair(cfg, jcfg, seed=2)
    return (lambda: vsrgan.create_gan_state(None, cfg, params_g=gp, params_d=dp, device="cpu"),
            _old_gan_step(cfg), vsrgan.make_gan_train_step(cfg), _gan_batches(5))


def _opt_state_equal(a: torch.optim.Optimizer, b: torch.optim.Optimizer) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for k in sb["state"]:
        assert sa["state"][k].keys() == sb["state"][k].keys()
        for key, v in sb["state"][k].items():
            assert torch.equal(sa["state"][k][key], v), (k, key)


def _assert_states_equal(a, b) -> None:
    assert a.step == b.step
    for tree in ("params", "params_g", "params_d"):
        if hasattr(type(a), "__dataclass_fields__") and tree in type(a).__dataclass_fields__:
            for x, y in zip(vsr.param_leaves(getattr(a, tree)), vsr.param_leaves(getattr(b, tree))):
                assert torch.equal(x, y), tree
    for name in ("opt", "opt_g", "opt_d"):
        if hasattr(a, name):
            _opt_state_equal(getattr(a, name), getattr(b, name))


CASES = ["vsr", "sisr", "denoise", "gan_0.3", "gan_0.7", "gan_skip", "gan_always"]


@pytest.mark.parametrize("name", CASES)
def test_split_step_equals_the_step_before_the_split(name):
    """The recipe's split step, run eagerly and through the driver's
    compiled step, against the step before the split, from one seeded
    state over the same batches: every log of every step, then the
    parameters, Adam's state, the step and the D updates, bit for bit."""
    make, old, new, batches = _case(name)
    states = {"old": make(), "split": make(), "compiled": make()}
    steps = {"old": old, "split": new, "compiled": compiled.TrainStepCache(new)}
    for i, (lr, gt) in enumerate(batches):
        logs = {k: steps[k](states[k], lr, gt)[1] for k in states}
        assert logs["split"].keys() == logs["old"].keys() == logs["compiled"].keys()
        for k in logs["old"]:
            for route in ("split", "compiled"):
                assert torch.equal(logs[route][k], logs["old"][k]), (i, route, k)
    for route in ("split", "compiled"):
        _assert_states_equal(states[route], states["old"])
        assert states[route].step == len(batches)
    if name.startswith("gan"):
        want = old.counts[id(states["old"])]
        assert {r: int(states[r].cnt_upd_d) for r in ("split", "compiled")} == {"split": want, "compiled": want}
        assert isinstance(states["split"].cnt_upd_d, torch.Tensor)
        if name in ("gan_0.3", "gan_0.7"):
            assert 0 < want < len(batches)
        if name == "gan_skip":
            assert want == 0 and states["split"].opt_d.state_dict()["state"] == {}


def test_gan_device_decision_matches_the_jax_step_over_mixed_decisions():
    """Five steps of the port's GAN step (its D decision on the device)
    and of the JAX step from the same weights on the same batches, under
    a threshold that updates D on steps 1, 2 and 4 and skips it on 3 and
    5: the same decision at every step, the same D count, and both
    networks' Adam moments and updates at test_torch_gan.py's tolerances
    for more than one step.  G's rate is 1e-4: at 1e-3 the two packages'
    float32 differences grow from step to step through the seeded
    recurrence, until after five steps G's moments lie 0.4 apart on small
    leaves."""
    cfg, jcfg = _gan_cfgs(lr_g=1e-4, lr_d=1e-3, update_threshold=0.7)
    gp, dp = _seeded_pair(cfg, jcfg, seed=2)
    state = vsrgan.create_gan_state(None, cfg, params_g=gp, params_d=dp, device="cpu")
    step = vsrgan.make_gan_train_step(cfg)
    jstate, jstep = _jax_state(jcfg, gp, dp), jax.jit(jvsrgan.make_gan_train_step(jcfg))
    decisions, jdecisions = [], []
    for lr, gt in _gan_batches(5):
        state, logs = step(state, lr, gt)
        jstate, jlogs = jstep(jstate, jnp.asarray(lr.numpy()), jnp.asarray(gt.numpy()))
        decisions.append(float(logs["l_gan_D"]) != 0.0)
        jdecisions.append(float(jlogs["l_gan_D"]) != 0.0)
        # the distances lie 0.14 or more from the threshold
        assert abs(float(logs["distance"]) - float(jlogs["distance"])) <= 1e-3
    assert decisions == jdecisions == [True, True, False, True, False]
    assert int(state.cnt_upd_d) == int(jstate.cnt_upd_d) == 3 and state.step == int(jstate.step) == 5
    _assert_moments_close(state.opt_g, state.params_g, jstate.opt_g, 1e-3)
    _assert_moments_close(state.opt_d, state.params_d, jstate.opt_d, 1e-3)
    _assert_updates_close(gp, state.params_g, jstate.params_g)
    _assert_updates_close(dp, state.params_d, jstate.params_d)


@pytest.mark.parametrize("name", ["vsr", "sisr", "denoise"])
def test_each_update_uses_the_rate_of_its_step(name):
    """The rate the optimizer reads at each update, through the driver's
    compiled step, is sched(k) at the k-th update (optax's convention)."""
    make, _, step, batches = _case(name)
    state = make()
    seen = []
    opt_step = state.opt.step
    state.opt.step = lambda *a, **kw: (seen.append([g["lr"] for g in state.opt.param_groups]), opt_step(*a, **kw))[1]
    fn = compiled.TrainStepCache(step)
    for lr, gt in batches:
        fn(state, lr, gt)
    assert seen == [[_sched(k)] for k in range(len(batches))]


def test_gan_rates_stay_fixed():
    make, _, step, batches = _case("gan_0.7")
    state = make()
    fn = compiled.TrainStepCache(step)
    for lr, gt in batches[:2]:
        fn(state, lr, gt)
    assert [g["lr"] for g in state.opt_g.param_groups] == [g["lr"] for g in state.opt_d.param_groups] == [1e-3]


def test_set_rate_fills_a_tensor_rate_in_place():
    """A tensor rate (the card's capturable optimizer holds one, which a
    graph reads where it lies) is filled, never replaced; a float one is
    set.  On the CPU make_optimizer is the plain optimizer, float rate."""
    p = torch.zeros(3, requires_grad=True)
    opt = torch.optim.Adam([p], lr=torch.tensor(1e-3), foreach=False)
    rate = opt.param_groups[0]["lr"]
    vsr.set_rate(opt, 2.5e-4)
    assert opt.param_groups[0]["lr"] is rate and float(rate) == np.float32(2.5e-4)
    plain = vsr.make_optimizer([p], 1e-3, 0.9, 0.999)
    assert isinstance(plain, torch.optim.Adam) and not plain.param_groups[0]["capturable"]
    vsr.set_rate(plain, 2.5e-4)
    assert plain.param_groups[0]["lr"] == 2.5e-4 and not plain.state


def test_gan_count_is_a_device_value_and_checkpoints_as_an_int(tmp_path):
    make, _, step, batches = _case("gan_0.7")
    state = make()
    for lr, gt in batches[:2]:
        step(state, lr, gt)
    assert isinstance(state.cnt_upd_d, torch.Tensor) and state.cnt_upd_d.dtype == torch.int64
    path = checkpoint.save_checkpoint(str(tmp_path), state, state.step)
    assert torch.load(path, weights_only=True)["cnt_upd_d"] == int(state.cnt_upd_d) == 2
    fresh = make()
    count = fresh.cnt_upd_d
    checkpoint.load_checkpoint(path, fresh)
    assert fresh.cnt_upd_d is count and int(count) == 2
    legacy = make()
    legacy.cnt_upd_d = 1  # a state built with an int count
    step(legacy, *batches[0])
    assert isinstance(legacy.cnt_upd_d, torch.Tensor) and int(legacy.cnt_upd_d) == 2


# ------------------------------------------------------------------ the checkpoint


def _tensor_rate_state(seed: int):
    """A TrainState over a tiny FRNet whose Adam holds its rate as a tensor
    and made its state at once, as the card's capturable one does."""
    cfg = vsr.VSRTrainConfig(model_cfg=egvsr.EGVSRConfig(nf=16, nb=1), lr=1e-3)
    state = vsr.create_train_state(torch.Generator().manual_seed(seed), cfg, device="cpu")
    leaves = vsr.param_leaves(state.params)
    state.opt = torch.optim.Adam(leaves, lr=torch.tensor(1e-3), betas=(0.9, 0.999), eps=1e-8, foreach=False)
    for p in leaves:
        state.opt.state[p] = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                              "exp_avg_sq": torch.zeros_like(p)}
    return cfg, state


@pytest.mark.parametrize("rate", ["float", "tensor"])
def test_checkpoint_loads_into_the_state_a_compiled_step_holds(tmp_path, rate):
    """Two steps through the driver's compiled step, a checkpoint, a third
    step, then the checkpoint loaded back into the same state: every
    tensor the step reads (parameters, moments, counts, a tensor rate)
    keeps its address, so the step keeps its signature, and the next step
    equals the third step of a straight run, bit for bit."""
    batches = [(_rand(60 + i, 2, 3, 8, 8, 3), _rand(70 + i, 2, 3, 32, 32, 3)) for i in range(3)]

    def fresh(seed=0):
        if rate == "tensor":
            return _tensor_rate_state(seed)
        cfg = vsr.VSRTrainConfig(model_cfg=egvsr.EGVSRConfig(nf=16, nb=1), lr=1e-3)
        return cfg, vsr.create_train_state(torch.Generator().manual_seed(seed), cfg, device="cpu")

    cfg, straight = fresh()
    step = compiled.TrainStepCache(vsr.make_train_step(cfg, _sched))
    for lr, gt in batches:
        step(straight, lr, gt)

    _, state = fresh()
    step = compiled.TrainStepCache(vsr.make_train_step(cfg, _sched))
    for lr, gt in batches[:2]:
        step(state, lr, gt)
    path = checkpoint.save_checkpoint(str(tmp_path), state, state.step)
    step(state, *batches[2])
    where = [t.data_ptr() for t in compiled.state_tensors(state)]
    rate_tensor = state.opt.param_groups[0]["lr"]
    checkpoint.load_checkpoint(path, state)
    assert state.step == 2 and [t.data_ptr() for t in compiled.state_tensors(state)] == where
    assert state.opt.param_groups[0]["lr"] is rate_tensor
    step(state, *batches[2])
    assert step.num_signatures == 1
    _assert_states_equal(state, straight)

    # a checkpoint into a fresh state of another seed, stepped on
    _, resumed = fresh(seed=1)
    checkpoint.load_checkpoint(path, resumed)
    step(resumed, *batches[2])
    _assert_states_equal(resumed, straight)


@pytest.fixture
def stood_in(monkeypatch):
    """The device's warm-up, capture and replay stood in for on the CPU:
    the warm-up runs the body, a capture and a replay only record their
    route; returns the routes taken, in order."""
    routes = []

    class Graph:
        def result(self):
            routes.append("capture")
            return {}

        def replay(self, leaves):
            routes.append("replay")
            return {}

    def warm_up(self, dev, state, inputs):
        routes.append("warm")
        return self._split.body(state, *inputs)

    monkeypatch.setattr(compiled, "_graph_device", lambda leaves: torch.device("cpu"))
    monkeypatch.setattr(compiled.TrainStepCache, "_warm_up", warm_up)
    monkeypatch.setattr(compiled.TrainStepCache, "_capture", lambda self, dev, state, inputs, struct, leaves: Graph())
    return routes


def test_another_state_or_replaced_tensors_are_another_signature(stood_in):
    """On the card a state's tensors are part of a signature (a graph
    reads them where they lie): a second state, or one whose optimizer
    state torch.optim's own load_state_dict replaced, counts anew, and
    warms up before its capture; a checkpoint loaded in place does not."""
    cfg, a = _tensor_rate_state(0)
    _, b = _tensor_rate_state(0)
    step = compiled.TrainStepCache(vsr.make_train_step(cfg))
    batch = (_rand(1, 1, 3, 8, 8, 3), _rand(2, 1, 3, 32, 32, 3))
    for _ in range(3):
        step(a, *batch)
    assert step.num_signatures == 1 and stood_in == ["warm", "capture", "replay"]
    step(b, *batch)
    assert step.num_signatures == 2 and stood_in[-1] == "warm"
    a.opt.load_state_dict(a.opt.state_dict())
    step(a, *batch)
    assert step.num_signatures == 3 and stood_in[-1] == "warm"
    step(a, _rand(3, 2, 3, 8, 8, 3), _rand(4, 2, 3, 32, 32, 3))  # another batch shape
    assert step.num_signatures == 4 and step.num_graphs == 1


def test_cache_life_cycle_and_graph_cap(stood_in, monkeypatch):
    """A signature's first call is the warm-up, its second the capture,
    later ones replays; the first MAX_GRAPHS recurring signatures are
    captured and any other runs eagerly; the prologue and the epilogue
    run at every call, whatever the body's route."""
    monkeypatch.setattr(compiled, "MAX_GRAPHS", 2)

    def body(state, x):
        stood_in.append("eager")
        return {}

    state = vsr.TrainState({"w": torch.zeros(2, requires_grad=True)}, None)
    state.opt = torch.optim.Adam(vsr.param_leaves(state.params), lr=torch.tensor(1.0), foreach=False)
    rates = []

    def prologue(s, x):
        vsr.set_rate(s.opt, float(s.step))
        rates.append(float(s.opt.param_groups[0]["lr"]))
        return (x,)

    fn = compiled.TrainStepCache(compiled.eager_step(compiled.SplitStep(prologue, body, vsr.count_update)))
    xs = [torch.ones(k + 1) for k in range(3)]
    for _ in range(3):
        for x in xs:
            fn(state, x)
    assert stood_in == ["warm", "eager"] * 3 + ["capture", "capture", "eager"] + ["replay", "replay", "eager"]
    assert state.step == 9 and rates == [float(k) for k in range(9)]
    assert fn.num_signatures == 3 and fn.num_graphs == 2


# ------------------------------------------------------------------ the driver


@pytest.fixture(scope="module")
def derived(tmp_path_factory):
    """4 panned 3-frame sequences of 48x48 GT (12x12 LR) from seeded
    stills and a 3-frame val sequence."""
    from sharkshark_tpu_torch.tools import make_derived_dataset as mdd

    root = tmp_path_factory.mktemp("graphs_derived")
    mdd.write_stills(str(root / "stills"), 3, 64, seed=2)
    mdd.main(["--src", str(root / "stills"), "--out", str(root / "data"), "--holdout", "still_000.png",
              "--seqs", "4", "--tempo", "3", "--crop", "48", "--pan", "4", "--val-tempo", "3"])
    return root


def _frnet_bd_config(root, name):
    """FRNet nf 8 / nb 1 on BD-degraded Folder data (GT crop 32, batch 2),
    three iterations with a test after each."""
    data = root / "data"
    return {
        "scale": 4, "manual_seed": 0,
        "dataset": {
            "degradation": {"type": "BD", "sigma": 1.5},
            "train": {"name": "Folder", "gt_seq_dir": str(data / "train" / "GT"),
                      "lr_seq_dir": str(data / "train" / "LR"), "crop_size": 32, "batch_size": 2, "num_workers": 0},
            "test1": {"gt_seq_dir": str(data / "val" / "GT"), "lr_seq_dir": str(data / "val" / "LR")},
        },
        "model": {"generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": 16, "nb": 1}},
        "train": {"tempo_extent": 3, "total_iter": 3, "ckpt_freq": 0, "ckpt_dir": str(root / f"ckpt_{name}"),
                  "resume": False, "pixel_crit": {"type": "CB", "weight": 1},
                  "warping_crit": {"type": "CB", "weight": 1}, "generator": {"lr": 5e-5}},
        "test": {"test_freq": 1, "metrics": ["PSNR"], "psnr_colorspace": "y", "profile_size": [16, 16]},
        "logger": {"log_freq": 1},
    }


def test_driver_routes_every_step_through_its_cache(derived, monkeypatch):
    """train(): the recipe's step is the compiled one (one signature over
    three equal batches), the BD degradation runs through its ShapeCache
    (one signature) and the three periodic tests through one inference
    cache (one signature); test() alone makes a cache of its own, and
    profile()'s benchmark_fps times one.  On the CPU nothing is
    captured."""
    made = {"steps": [], "shape_caches": []}

    class StepSpy(compiled.TrainStepCache):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["steps"].append(self)

    monkeypatch.setattr(driver, "TrainStepCache", StepSpy)

    class Spy(jit_cache.ShapeCache):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["shape_caches"].append(self)

    monkeypatch.setattr(jit_cache, "ShapeCache", Spy)
    monkeypatch.setattr(driver, "ShapeCache", Spy)
    opt = _frnet_bd_config(derived, "routes")
    res = driver.train(opt, device="cpu")
    assert res["iter"] == 3 and len(res["tests"]) == 3
    (step,) = made["steps"]
    assert isinstance(step, compiled.TrainStepCache)
    assert (step.num_signatures, step.num_graphs) == (1, 0)
    assert res["step_graphs"] == {"signatures": 1, "graphs": 0} == res["test_graphs"]
    degrade, infer = made["shape_caches"]
    assert (degrade.num_signatures, infer.num_signatures) == (1, 1)

    driver.test(opt, params=driver.build_training(opt, "cpu").state.params, device="cpu")
    assert len(made["shape_caches"]) == 3 and made["shape_caches"][-1].num_signatures == 1
    driver.profile(opt, device="cpu")
    assert len(made["shape_caches"]) == 4 and made["shape_caches"][-1].num_signatures == 1


@pytest.mark.parametrize("recipe", ["frnet", "srvgg", "bsvd", "gan"])
def test_build_training_compiles_each_recipe(derived, recipe):
    """Every recipe's step comes back compiled, with the recipe's plain
    step as `eager`; a batch of another shape is a new signature."""
    opt = _frnet_bd_config(derived, recipe)
    if recipe == "srvgg":
        opt["model"]["generator"] = {"name": "srvgg", "nf": 8, "num_conv": 2}
    elif recipe == "bsvd":
        opt["model"]["generator"] = {"name": "bsvd"}
    elif recipe == "gan":
        opt["model"]["discriminator"] = {"name": "STNet", "in_nc": 3, "tempo_range": 3}
        opt["dataset"]["train"]["crop_size"] = SIZE
    r = driver.build_training(opt, "cpu")
    assert isinstance(r.step, compiled.TrainStepCache) and hasattr(r.step.eager, "split")
    lr_hw, gt_hw = (16, 16) if recipe == "bsvd" else (SIZE // 4, SIZE)
    for batch in (1, 1, 2):
        r.step(r.state, _rand(batch, batch, 3, lr_hw, lr_hw, 3), _rand(batch + 5, batch, 3, gt_hw, gt_hw, 3))
    assert (r.step.num_signatures, r.step.num_graphs, r.state.step) == (2, 0, 3)
