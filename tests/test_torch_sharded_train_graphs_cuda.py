"""The sharded VSR train step compiled per signature on the card
(sharkshark_tpu_torch/parallel/sharded.py::make_sharded_train_step), against
its own eager step (`fn.eager`).

- On a mesh that repeats one card (`[cuda:0] * n`), the whole step
  (the forward over every band and frame, the backward and the
  capturable Adam) is one CUDA graph a signature (a TrainStepCache):
  under deterministic algorithms it equals the eager sharded step bit for
  bit over six steps (warm-up, capture, four replays) at 2 x 2 (the halo
  covers the clip) and at spatial 2 (the bands cut): every log, the
  gradients of every step, the parameters, Adam's moments, counts and
  rate, and the step; one signature, one graph.
- No gradient carries over between replays: two replays from the same
  state, loaded back in place, leave the same gradients, those of one
  eager step.
- The per-band segment graphs (the route of a mesh over distinct cards),
  built on one card, equal the eager step bit for bit: on one device
  autograd runs every band's backward on one thread, in one order.
- Across two or more cards (skipped below two) the segment graphs'
  first replayed step lies within 1e-5 of the eager step leaf by leaf:
  each card's backward runs on its own thread, so the order in which the
  first card adds the cards' gradient parts varies from run to run.
- A dropped segment step frees its graphs at once: a later capture that
  runs the cycle collector is not ended by a graph freed under it.
- A host read put into the body fails the capture, loudly (last: a
  failed capture is the last thing a process should do on a card).

These tests need an NVIDIA GPU, so they carry the `cuda` marker and
skip on a host without CUDA.  On the card, without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_sharded_train_graphs_cuda.py
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from sharkshark_tpu_torch import parallel as par
from sharkshark_tpu_torch.models import egvsr
from sharkshark_tpu_torch.parallel import sharded
from sharkshark_tpu_torch.train import compiled, vsr

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


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


CFG = vsr.VSRTrainConfig(model_cfg=egvsr.EGVSRConfig(nf=16, nb=2), lr=1e-3)


def _state(dev):
    return vsr.create_train_state(torch.Generator().manual_seed(0), CFG, device=dev)


def _batches(dev, data, w, steps=6, t=4):
    return [(_rand(i, dev, 2 * data, t, 16, w, 3), _rand(10 + i, dev, 2 * data, t, 64, 4 * w, 3))
            for i in range(steps)]


def _mesh(devices, data, spatial):
    return par.make_mesh(devices=devices, data=data, spatial=spatial)


def _snapshot(state) -> list:
    return [t.detach().clone() for t in compiled.state_tensors(state)]


def _load(state, snap: list) -> None:
    """The snapshot written back into the state's own tensors, as a
    checkpoint loads: the compiled step keeps its signature."""
    with torch.no_grad():
        for t, v in zip(compiled.state_tensors(state), snap):
            t.copy_(v)
    state.step = 0


def _grads(state) -> list:
    return [p.grad.detach().clone() for p in vsr.param_leaves(state.params)]


def _assert_identical(a: list, b: list, what) -> None:
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), (what, i)


def _hold_bit_for_bit(fn, batches, dev) -> None:
    with deterministic():
        eager, graphed = _state(dev), _state(dev)
        for i, (lr, gt) in enumerate(batches):
            want = fn.eager(eager, lr, gt)[1]
            got = fn(graphed, lr, gt)[1]
            assert got.keys() == want.keys() == {"l_pix_G", "l_warp_G", "l_total"}
            for k in want:
                assert torch.equal(got[k], want[k]), (i, k)
            _assert_identical(_grads(graphed), _grads(eager), ("grads", i))
        torch.cuda.synchronize()
        assert graphed.step == eager.step == len(batches)
        _assert_identical(_snapshot(graphed), _snapshot(eager), "state")


@pytest.mark.parametrize("data,spatial,w", [(2, 2, 32), (1, 2, 256)], ids=["halo_covers_2x2", "bands_cut_s2"])
def test_one_card_mesh_whole_step_graph_equals_the_eager_step(dev, data, spatial, w):
    fn = par.make_sharded_train_step(vsr.make_train_step(CFG, _sched), _mesh([dev] * (data * spatial), data,
                                                                             spatial))
    assert isinstance(fn, compiled.TrainStepCache)
    _hold_bit_for_bit(fn, _batches(dev, data, w), dev)
    assert (fn.num_signatures, fn.num_graphs) == (1, 1)


def test_no_gradient_carries_over_between_replays(dev):
    fn = par.make_sharded_train_step(vsr.make_train_step(CFG, _sched), _mesh([dev] * 4, 2, 2))
    lr, gt = _batches(dev, 2, 32, steps=1)[0]
    with deterministic():
        state = _state(dev)
        start = _snapshot(state)
        for _ in range(3):  # warm-up, capture, replay
            fn(state, lr, gt)
        replays = []
        for _ in range(2):
            _load(state, start)
            fn(state, lr, gt)
            replays.append(_grads(state))
        eager = _state(dev)
        fn.eager(eager, lr, gt)
    assert fn.num_graphs == 1
    _assert_identical(replays[1], replays[0], "second replay")
    _assert_identical(replays[0], _grads(eager), "eager")
    assert all(float(g.abs().max()) > 0 for g in replays[0][:4])


def test_segment_graphs_on_one_card_equal_the_eager_step(dev):
    """The route of several cards, its segments graphed on one: bit for bit."""
    t = 4
    fn = sharded._SegmentGraphs(
        par.make_sharded_train_step(vsr.make_train_step(CFG, _sched), _mesh([dev] * 4, 2, 2)).eager)
    _hold_bit_for_bit(fn, _batches(dev, 2, 256, steps=5, t=t), dev)
    # 2 data rows x 2 bands, each a front, t frames and a pix segment, each
    # a forward and a backward graph
    assert (fn.num_signatures, fn.num_graphs) == (1, 2 * 4 * (t + 2))


def test_segment_graphs_across_cards_against_the_eager_step(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    cards = [torch.device("cuda", i) for i in range(min(n, 4))]
    data, spatial = (2, 2) if len(cards) == 4 else (1, 2)
    fn = par.make_sharded_train_step(vsr.make_train_step(CFG, _sched), _mesh(cards[: data * spatial], data, spatial))
    assert isinstance(fn, sharded._SegmentGraphs)
    lr, gt = _batches(dev, data, 256, steps=1)[0]
    with deterministic():
        state = _state(dev)
        start = _snapshot(state)
        for _ in range(2):  # warm-up and capture
            fn(state, lr, gt)
        _load(state, start)
        eager = _state(dev)
        got, want = fn(state, lr, gt)[1], fn.eager(eager, lr, gt)[1]
        for k in want:
            assert abs(float(got[k]) - float(want[k])) <= 1e-6 * abs(float(want[k])), k
        for a, b in zip(_grads(state), _grads(eager)):
            assert float((a - b).norm()) <= 1e-5 * float(b.norm())
        for _ in range(3):
            got, want = fn(state, lr, gt)[1], fn.eager(eager, lr, gt)[1]
            assert abs(float(got["l_total"]) - float(want["l_total"])) <= 1e-4 * abs(float(want["l_total"]))
    assert fn.num_signatures == 1 and fn.num_graphs == 2 * data * spatial * (4 + 2)


def test_a_dropped_segment_step_does_not_end_a_later_capture(dev):
    """The segment graphs of a dropped step are freed when it is dropped:
    a later capture that runs the cycle collector (an allocation may)
    frees no graph under it, which would end the capture."""
    fn = sharded._SegmentGraphs(
        par.make_sharded_train_step(vsr.make_train_step(CFG, _sched), _mesh([dev] * 2, 1, 2)).eager)
    lr, gt = _batches(dev, 1, 32, steps=1)[0]
    state = _state(dev)
    for _ in range(2):
        fn(state, lr, gt)
    assert fn.num_graphs > 0
    del fn, state

    def body(state, x):
        gc.collect()
        vsr.optimizer_update(state.opt, (state.params["w"] * x).sum())
        return {}

    w = torch.ones(8, device=dev, requires_grad=True)
    one = vsr.TrainState({"w": w}, vsr.make_optimizer([w], 1e-2, 0.9, 0.999))
    cache = compiled.TrainStepCache(compiled.eager_step(compiled.SplitStep(lambda s, x: (x,), body, vsr.count_update)))
    for _ in range(3):
        cache(one, torch.ones(8, device=dev))
    assert cache.num_graphs == 1 and one.step == 3


def test_a_host_read_in_the_body_fails_the_capture(dev):
    split = par.make_sharded_train_step(vsr.make_train_step(CFG, _sched), _mesh([dev] * 2, 1, 2)).split

    def body(state, lr, gt):
        logs = split.body(state, lr, gt)
        if float(logs["l_total"]) > 0:  # a host read
            pass
        return logs

    fn = compiled.TrainStepCache(compiled.eager_step(compiled.SplitStep(split.prologue, body, split.epilogue)))
    lr, gt = _batches(dev, 1, 32, steps=1)[0]
    state = _state(dev)
    stream = torch.cuda.current_stream()
    fn(state, lr, gt)  # the warm-up runs eagerly
    with pytest.raises(RuntimeError):
        fn(state, lr, gt)
    assert fn.num_graphs == 0 and torch.cuda.current_stream() == stream
