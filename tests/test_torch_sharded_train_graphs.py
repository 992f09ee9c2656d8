"""The sharded VSR train step compiled per input signature
(sharkshark_tpu_torch/parallel/sharded.py::make_sharded_train_step, the
counterpart of the JAX function's jax.jit), on the CPU, where the
compiled step runs its body eagerly and nothing is captured.

- The step's three parts (`fn.split`: host prologue, device body, host
  epilogue) run in order equal the sharded step as it was before the
  split (kept below: the bands' losses, then vsr.apply_gradients), bit
  for bit over two steps at a rate that changes every step: logs,
  gradients, parameters, Adam's moments and counts, state.step.  At a
  width the halo covers whole and at one the bands cut (2 and 4 bands),
  with summing and mean criteria.  So does the compiled step, and its
  `.eager` step.
- The route from the mesh's devices: one distinct device (the CPU
  repeated, or one card repeated) gives a TrainStepCache of the whole
  body, several distinct cards the per-band segment graphs
  (_SegmentGraphs); the devices are only named, nothing runs on them.
- The life cycle of both routes with the device stood in for: warm-up,
  capture, replay; another batch shape or another state is another
  signature; the prologue and the epilogue run at every call.  The
  segment route records every band's segments in the order they run,
  graphs them by (data row, band), and replays them.
- A dropped segment step frees its graphs at once, without waiting for
  the cycle collector.
- The prologue puts the batch on the mesh's first device before the body.
- A step compiled by train.compiled.TrainStepCache (the driver's) gives
  the same sharded step as the plain step: it passes loss_fn and
  schedule through.

tests/test_torch_parallel_train.py holds the step against the JAX step
and the single-device step (through the compiled object: on the CPU it
runs eagerly); tests/test_torch_sharded_train_graphs_cuda.py holds the
graphs themselves on the card.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from sharkshark_tpu_torch import parallel as par
from sharkshark_tpu_torch.models import egvsr
from sharkshark_tpu_torch.ops import space_to_depth
from sharkshark_tpu_torch.ops.warp import backward_warp_columns
from sharkshark_tpu_torch.parallel import _bands, sharded
from sharkshark_tpu_torch.train import compiled, vsr, vsrgan
from sharkshark_tpu_torch.train.losses import criterion_parts

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def _sched(k):
    """A rate that differs at every step."""
    return 1e-3 * 0.7**k


def _mesh(n, spatial, devices=None):
    return par.make_mesh(devices=devices or [CPU] * n, spatial=spatial)


def _cfg(nb=1, **kw):
    return vsr.VSRTrainConfig(model_cfg=egvsr.EGVSRConfig(nf=16, nb=nb), lr=1e-3, **kw)


def _state(cfg, seed=1):
    return vsr.create_train_state(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _card_like_state(cfg, seed=1):
    """A state whose Adam holds its rate as a tensor and made its state
    at once, as the card's capturable one does (a float rate would be
    part of the signature, another at every step of _sched)."""
    state = _state(cfg, seed)
    leaves = vsr.param_leaves(state.params)
    state.opt = torch.optim.Adam(leaves, lr=torch.tensor(cfg.lr), betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                                 foreach=False)
    for p in leaves:
        state.opt.state[p] = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                              "exp_avg_sq": torch.zeros_like(p)}
    return state


def _batches(data, w, steps=2, t=3):
    return [(_rand(10 + i, 2 * data, t, 8, w, 3), _rand(20 + i, 2 * data, t, 32, 4 * w, 3)) for i in range(steps)]


# ------------------------------------------------ the sharded step before the split


def _old_band_train_losses(reps, bands, lr_data, gt_data, cfg, pix_part, warp_part, dev0):
    """parallel/sharded.py::_band_train_losses as it was before the split."""
    put, on_device = _bands.put, _bands.on_device
    n, t, h, w, c = lr_data.shape
    s = cfg.scale
    xs, hr_flows, sums = [], [], [0.0, 0.0]
    lr_prev_whole = lr_data[:, :-1].reshape(n * (t - 1), h, w, c)
    lr_curr_whole = lr_data[:, 1:].reshape(n * (t - 1), h, w, c)
    for band in bands:
        p, bw = reps[band.device], band.hi - band.lo
        centre = slice(band.c0 - band.lo, band.c1 - band.lo)
        with on_device(band.device):
            x = put(lr_data[:, :, :, band.lo : band.hi], band.device)
            lr_prev = x[:, :-1].reshape(n * (t - 1), h, bw, c)
            lr_curr = x[:, 1:].reshape(n * (t - 1), h, bw, c)
            lr_flow = egvsr._lr_flow(p, lr_curr, lr_prev)
            hr_flows.append(egvsr._upsample_flow(lr_flow, h, bw, cfg).reshape(n, t - 1, h * s, bw * s, 2))
            lr_warp = backward_warp_columns(put(lr_prev_whole, band.device), lr_flow, band.lo)
            y = put(lr_curr_whole[:, :, band.c0 : band.c1], band.device)
            sums[1] = sums[1] + put(warp_part(lr_warp[:, :, centre], y), dev0)
        xs.append(x)
    hrs = []
    for band, x in zip(bands, xs):
        with on_device(band.device):
            zero = x.new_zeros((n, h, band.hi - band.lo, s * s * c))
            hrs.append([egvsr.srnet_apply(reps[band.device]["srnet"], x[:, 0], zero)])
    for i in range(1, t):
        hr_prev = _bands.gather_bands([hr[-1] for hr in hrs], bands, w, s * w, 2, dev0)
        whole = {}
        for band, x, hr, flow in zip(bands, xs, hrs, hr_flows):
            if band.device not in whole:
                whole[band.device] = put(hr_prev, band.device)
            with on_device(band.device):
                warped = backward_warp_columns(whole[band.device], flow[:, i - 1], s * band.lo)
                hr.append(egvsr.srnet_apply(reps[band.device]["srnet"], x[:, i], space_to_depth(warped, s)))
    for band, hr in zip(bands, hrs):
        centre = slice(s * (band.c0 - band.lo), s * (band.c1 - band.lo))
        with on_device(band.device):
            gt = put(gt_data[:, :, :, s * band.c0 : s * band.c1], band.device)
            sums[0] = sums[0] + put(pix_part(torch.stack(hr, dim=1)[:, :, :, centre], gt), dev0)
    return sums


def _old_sharded_step(cfg, sched, mesh):
    """make_sharded_train_step's step as it was before the split."""
    pix = criterion_parts(cfg.pixel_crit or {"type": "CB"})
    warp = criterion_parts(cfg.warping_crit or {"type": "CB"})
    rows = [list(r) for r in mesh.devices]
    devices = mesh.device_list
    halo = sharded.egvsr_radius(cfg.model_cfg)

    def fn(state, lr_data, gt_data):
        n, t, h, w, c = lr_data.shape
        reps = _bands.replicate(state.params, devices)
        nb = n // len(rows)
        sums = [0.0, 0.0]
        for r, row in enumerate(rows):
            bands = _bands.split_width(w, row, sharded._FNET_ALIGN, halo)
            parts = _old_band_train_losses(reps, bands, lr_data[r * nb : (r + 1) * nb],
                                           gt_data[r * nb : (r + 1) * nb], cfg.model_cfg, pix[0], warp[0],
                                           devices[0])
            sums = [a + b for a, b in zip(sums, parts)]
        s = cfg.model_cfg.scale
        counts = (n * t * h * s * w * s * c, n * (t - 1) * h * w * c)
        loss_pix, loss_warp = (
            weight * (total / count if mean else total)
            for weight, total, count, mean in zip((cfg.pixel_weight, cfg.warping_weight), sums, counts,
                                                  (pix[1], warp[1])))
        loss = loss_pix + loss_warp
        vsr.apply_gradients(state, loss, sched)
        logs = {"l_pix_G": loss_pix, "l_warp_G": loss_warp, "l_total": loss}
        return state, {k: v.detach() for k, v in logs.items()}

    return fn


def _split_in_order(split):
    def step(state, *batch):
        inputs = split.prologue(state, *batch)
        logs = split.body(state, *inputs)
        split.epilogue(state)
        return state, logs

    return step


def _assert_states_equal(a, b) -> None:
    assert a.step == b.step
    pa, pb = vsr.param_leaves(a.params), vsr.param_leaves(b.params)
    for i, (x, y) in enumerate(zip(pa, pb)):
        assert torch.equal(x, y), ("param", i)
        assert torch.equal(x.grad, y.grad), ("grad", i)
        sa, sb = a.opt.state[x], b.opt.state[y]
        assert sa.keys() == sb.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for key in sb:
            assert torch.equal(torch.as_tensor(sa[key]), torch.as_tensor(sb[key])), (key, i)


@pytest.mark.parametrize("w,n,spatial,crit", [
    (16, 4, 2, {}),
    (256, 2, 2, {}),
    (256, 4, 4, {}),
    (256, 2, 2, {"pixel_crit": {"type": "MSE"}, "warping_crit": {"type": "CB", "reduction": "mean"}}),
], ids=["halo_covers_w16_d2xs2", "bands_cut_w256_s2", "bands_cut_w256_s4", "mean_criteria_w256_s2"])
def test_split_equals_the_step_before_the_split(w, n, spatial, crit):
    """fn.split's parts run in order, fn itself (compiled: eager on the
    CPU) and fn.eager against the sharded step before the split, each
    from one seeded state over two batches: every log of every step,
    then the gradients, the parameters, Adam's moments and counts and
    state.step, bit for bit."""
    cfg = _cfg(**crit)
    mesh = _mesh(n, spatial)
    fn = par.make_sharded_train_step(vsr.make_train_step(cfg, _sched), mesh)
    steps = {"old": _old_sharded_step(cfg, _sched, mesh), "split": _split_in_order(fn.split), "compiled": fn,
             "eager": fn.eager}
    states = {k: _state(cfg) for k in steps}
    for i, (lr, gt) in enumerate(_batches(n // spatial, w)):
        logs = {k: steps[k](states[k], lr, gt)[1] for k in steps}
        for route in ("split", "compiled", "eager"):
            assert logs[route].keys() == logs["old"].keys() == {"l_pix_G", "l_warp_G", "l_total"}
            for k in logs["old"]:
                assert torch.equal(logs[route][k], logs["old"][k]), (i, route, k)
    for route in ("split", "compiled", "eager"):
        _assert_states_equal(states[route], states["old"])
        assert states[route].step == 2
    assert float(states["compiled"].opt.param_groups[0]["lr"]) == _sched(1)
    bands = _bands.split_width(w, [CPU] * spatial, 8, par.egvsr_radius(cfg.model_cfg))
    assert (w == 16) == all((b.lo, b.hi) == (0, w) for b in bands)


# ------------------------------------------------------------------ the route


@pytest.mark.parametrize("devices,spatial,route", [
    (["cpu"] * 4, 2, "whole"),
    (["cuda:0"] * 4, 2, "whole"),
    (["cuda:0"] * 2, 2, "whole"),
    (["cuda:0", "cuda:1"] * 2, 2, "segments"),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], 2, "segments"),
    (["cuda:0", "cuda:1"], 2, "segments"),
    (["cuda:0", "cuda:1"], 1, "segments"),
], ids=["cpu_x4", "one_card_x4", "one_card_x2", "two_cards_x2", "four_cards", "two_cards_spatial",
        "two_cards_data"])
def test_the_route_follows_the_mesh_devices(devices, spatial, route):
    """One distinct device: the whole body in one TrainStepCache; more:
    the per-band segment graphs.  Both wrap the same eager step and pass
    its loss function and schedule on (the devices are only named)."""
    step = vsr.make_train_step(_cfg(), _sched)
    fn = par.make_sharded_train_step(step, _mesh(len(devices), spatial, devices))
    assert type(fn) is (compiled.TrainStepCache if route == "whole" else sharded._SegmentGraphs)
    assert fn.split is fn.eager.split
    assert fn.loss_fn is step.loss_fn and fn.schedule is step.schedule
    assert (fn.num_signatures, fn.num_graphs) == (0, 0)


# ------------------------------------------------------------------ life cycles


@pytest.fixture
def stood_in(monkeypatch):
    """TrainStepCache's warm-up, capture and replay stood in for on the
    CPU: the warm-up runs the body, a capture and a replay record their
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


def test_whole_body_life_cycle(stood_in):
    """On a mesh of one device: the first call of a signature warms up,
    the second captures, later ones replay; another batch shape and
    another state are other signatures; the prologue (the rate) and the
    epilogue (the count) run at every call."""
    cfg = _cfg()
    rates = []
    fn = par.make_sharded_train_step(vsr.make_train_step(cfg, lambda k: rates.append(k) or _sched(k)), _mesh(4, 2))
    a, b = _card_like_state(cfg), _card_like_state(cfg)
    (lr, gt), = _batches(2, 16, steps=1)
    for _ in range(3):
        fn(a, lr, gt)
    assert stood_in == ["warm", "capture", "replay"] and fn.num_signatures == 1
    fn(a, lr[:, :2], gt[:, :2])  # another clip length
    fn(b, lr, gt)
    assert stood_in[3:] == ["warm", "warm"] and fn.num_signatures == 3 and fn.num_graphs == 1
    assert a.step == 4 and b.step == 1 and rates == [0, 1, 2, 3, 0]


def _stand_in_segments(monkeypatch):
    """_SegmentGraphs on the CPU with the card stood in for: every call's
    tensors count as the card's, and make_graphed_callables records what
    it was given and returns callables that run the segment and record
    each replay.  Returns (captures, replays)."""
    captures, replays = [], []

    def make_graphed_callables(fns, args):
        captures.append((fns, args))
        return tuple((lambda *a, f=f: replays.append(f) or f(*a)) for f in fns)

    monkeypatch.setattr(sharded, "_on_card", lambda tensors: True)
    monkeypatch.setattr(torch.cuda, "make_graphed_callables", make_graphed_callables)
    return captures, replays


@pytest.mark.parametrize("n,spatial", [(2, 2), (4, 2)], ids=["spatial2", "data2_spatial2"])
def test_segment_graphs_life_cycle(monkeypatch, n, spatial):
    """The segment route on the CPU, the card stood in for: the first call
    of a signature runs eagerly and records each band's segments (front,
    a frame each, pix), the second graphs them by (data row, band) in
    the order they ran, "front" apart from the frames and pix (two
    pools: front's backward and frame 0's may run in either order), on
    zeros of the recorded arguments' shapes that require grad where the
    call's did (the state's own parameters kept as themselves), then
    runs through them; later calls replay.  Every call equals the eager
    step bit for bit; another batch shape and another state are other
    signatures."""
    captures, replays = _stand_in_segments(monkeypatch)
    cfg, t = _cfg(), 3
    step = vsr.make_train_step(cfg, _sched)
    mesh = _mesh(n, spatial)
    fn = sharded._SegmentGraphs(par.make_sharded_train_step(step, mesh).eager)
    eager = par.make_sharded_train_step(step, mesh).eager
    got, want = _card_like_state(cfg), _card_like_state(cfg)
    batches = _batches(n // spatial, 256, steps=4, t=t)
    for i, (lr, gt) in enumerate(batches):
        logs = fn(got, lr, gt)[1]
        ref = eager(want, lr, gt)[1]
        for k in ref:
            assert torch.equal(logs[k], ref[k]), (i, k)
        segments = (n // spatial) * spatial * (t + 2)
        assert len(captures) == (0 if i == 0 else 2 * n)
        assert len(replays) == i * segments
    _assert_states_equal(got, want)
    assert fn.num_signatures == 1 and fn.num_graphs == 2 * (n // spatial) * spatial * (t + 2)
    params = {id(p) for p in vsr.param_leaves(got.params)}
    fronts = [c for c in captures if c[0][0].__name__ == "front"]
    chains = [c for c in captures if c[0][0].__name__ != "front"]
    assert len(fronts) == len(chains) == n
    for (front, front_args), (fns, args) in zip(fronts, chains):
        assert [f.__name__ for f in front] == ["front"]
        assert [f.__name__ for f in fns] == ["first_frame"] + ["frame"] * (t - 1) + ["pix"]
        fnet, x, lr_prev, y = front_args[0]
        assert all(p.requires_grad for p in _bands._leaves(fnet))
        assert not (x.requires_grad or lr_prev.requires_grad or y.requires_grad)
        assert x.shape[:3] == (2, t, 8) and not x.any()  # zeros of a data row's band columns
        srnet, xi, whole, flow = args[1]
        assert whole.requires_grad and flow.requires_grad and not xi.requires_grad
        assert all(p.requires_grad for p in _bands._leaves(srnet))
        assert [p.data_ptr() for p in _bands._leaves(srnet)] == [
            p.data_ptr() for p in _bands._leaves(got.params["srnet"])]
        assert not any(id(p) in params for p in _bands._leaves(srnet))
        gt_c, *hrs = args[-1]
        assert not gt_c.requires_grad and len(hrs) == t and all(h.requires_grad for h in hrs)
    fn(got, *_batches(n // spatial, 128, steps=1, t=t)[0])
    fn(_card_like_state(cfg), *batches[0])
    assert fn.num_signatures == 3 and len(captures) == 2 * n


def test_a_dropped_segment_step_frees_its_graphs_at_once(monkeypatch):
    """make_graphed_callables' callables live in reference cycles (a class
    each): a dropped segment step collects them at once, so that no graph
    waits for the cycle collector, which might run in the middle of
    another capture.  The stand-in's callables hold an object in a cycle
    of its own; with the collector off, dropping the step frees them."""

    class Cyclic:
        def __init__(self):
            self.me = self

    held = []

    def make_graphed_callables(fns, args):
        cyclic = Cyclic()
        held.append(weakref.ref(cyclic))
        return tuple((lambda *a, f=f, c=cyclic: f(*a)) for f in fns)

    monkeypatch.setattr(sharded, "_on_card", lambda tensors: True)
    monkeypatch.setattr(torch.cuda, "make_graphed_callables", make_graphed_callables)
    cfg = _cfg()
    fn = sharded._SegmentGraphs(par.make_sharded_train_step(vsr.make_train_step(cfg, _sched), _mesh(2, 2)).eager)
    state = _card_like_state(cfg)
    (lr, gt), = _batches(1, 16, steps=1)
    gc.disable()
    try:
        for _ in range(2):  # the recording call, then the capture
            fn(state, lr, gt)
        assert len(held) == 4 and all(r() is not None for r in held)  # a front and a chain a band
        del fn
        assert all(r() is None for r in held)
    finally:
        gc.enable()


def test_a_host_batch_is_put_on_the_first_device(monkeypatch):
    """The prologue moves the batch to the mesh's first device (through
    parallel._bands.put: pinned memory and a copy that does not wait),
    and the body gets what it moved."""
    cfg = _cfg()
    mesh = _mesh(4, 2, ["cpu"] * 4)
    fn = par.make_sharded_train_step(vsr.make_train_step(cfg, _sched), mesh)
    moved = []

    def put(x, dev):
        moved.append((x, dev))
        return x.clone()

    monkeypatch.setattr(sharded, "put", put)
    (lr, gt), = _batches(2, 16, steps=1)
    state = _state(cfg)
    inputs = fn.split.prologue(state, lr, gt)
    assert [(x is y, dev) for (x, dev), y in zip(moved, (lr, gt))] == [(True, CPU), (True, CPU)]
    assert all(a is not b and torch.equal(a, b) for a, b in zip(inputs, (lr, gt)))
    seen = []
    monkeypatch.setattr(fn, "_split", fn.split._replace(body=lambda s, *xs: seen.extend(xs) or {}))
    fn(state, lr, gt)
    assert len(moved) == 4 and seen[0] is not lr and torch.equal(seen[0], lr)


def test_the_driver_compiled_step_shards_as_the_plain_step():
    """make_sharded_train_step(TrainStepCache(step)) equals
    make_sharded_train_step(step) bit for bit over two steps: the cache
    passes the step's loss function and schedule on; a GAN step, which
    has none, is refused through the cache as it is without it."""
    cfg = _cfg()
    step = vsr.make_train_step(cfg, _sched)
    cached = compiled.TrainStepCache(step)
    assert cached.loss_fn is step.loss_fn and cached.schedule is step.schedule
    mesh = _mesh(4, 2)
    fns = {"plain": par.make_sharded_train_step(step, mesh), "cached": par.make_sharded_train_step(cached, mesh)}
    states = {k: _state(cfg) for k in fns}
    for lr, gt in _batches(2, 16):
        logs = {k: fns[k](states[k], lr, gt)[1] for k in fns}
        for k in logs["plain"]:
            assert torch.equal(logs["cached"][k], logs["plain"][k]), k
    _assert_states_equal(states["cached"], states["plain"])
    gan = compiled.TrainStepCache(vsrgan.make_gan_train_step(vsrgan.VSRGANConfig()))
    assert not hasattr(gan, "loss_fn")
    with pytest.raises(TypeError, match="no loss_fn and no schedule"):
        par.make_sharded_train_step(gan, mesh)
