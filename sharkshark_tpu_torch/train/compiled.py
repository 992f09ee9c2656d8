"""Whole train steps compiled per input signature: forward, backward and
optimizer update in one CUDA graph (counterpart of the JAX driver's
`jax.jit` of each recipe's train step, train/driver.py).

A recipe's step is a SplitStep of three parts:
- prologue(state, *batch) -> inputs: host work, run at every call: the
  rate sched(state.step) filled into the optimizer's rate tensor
  (vsr.set_rate), noise seeded from the host step (train/denoise.py);
- body(state, *inputs) -> logs: device work only (loss, backward,
  optimizer step), which reads and writes the state's tensors in place
  and returns a dict of tensors.  A Python side effect here would run
  once, at the capture, and a host read (`.item()`, `bool(tensor)`)
  fails the capture;
- epilogue(state): host work after the body (the update count).

eager_step(split) runs the three in order: the step a recipe returns.
TrainStepCache(step) runs the prologue and the epilogue around a CUDA
graph of the body per input signature, with upscale/jit_cache.py's
ShapeCache life cycle (the first call of a signature eager, the second
captured, later calls replayed; CPU tensors eager; MAX_GRAPHS at most;
a failed capture or replay raises).  The state is a fixed argument: the
graph reads and writes its parameters, optimizer moments, counts and
rate where they lie, so the state the caller holds is the state the
graph updates, and nothing of it is copied at a replay.  The body's
inputs pass through static buffers; its logs are cloned after a replay.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..upscale.jit_cache import MAX_GRAPHS, GraphPool, _add_counters, _counter_delta, _fill, _flatten, _graph_device
from ..upscale.jit_cache import _leaf_sig, _read_counters, _unflatten
from .vsr import param_leaves

__all__ = ["SplitStep", "eager_step", "state_tensors", "TrainStepCache"]


class SplitStep(NamedTuple):
    prologue: Callable
    body: Callable
    epilogue: Callable


def eager_step(split: SplitStep):
    """The step `train_step(state, *batch) -> (state, logs)` that runs
    split's three parts eagerly, with the split as `train_step.split`."""

    def train_step(state, *batch):
        inputs = split.prologue(state, *batch)
        logs = split.body(state, *inputs)
        split.epilogue(state)
        return state, logs

    train_step.split = split
    return train_step


def _fields(state) -> list:
    return [getattr(state, f.name) for f in dataclasses.fields(state)]


def state_tensors(state) -> list[torch.Tensor]:
    """Every tensor a step's body reads or writes in place: the parameter
    trees, each optimizer's tensor rates and per-leaf state (moments,
    counts) and the state's tensor fields (a GAN state's D updates)."""
    out = []
    for v in _fields(state):
        if isinstance(v, (dict, list)):
            out += param_leaves(v)
        elif isinstance(v, torch.optim.Optimizer):
            for group in v.param_groups:
                if isinstance(group["lr"], torch.Tensor):
                    out.append(group["lr"])
                for p in group["params"]:
                    out += [t for t in v.state.get(p, {}).values() if isinstance(t, torch.Tensor)]
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def _state_sig(state, tensors: list) -> tuple:
    """The state's part of a signature: where each of its tensors lies
    (the graph reads them there) and the optimizers' other settings, a
    float rate among them (a graph holds them as constants; the card's
    optimizers hold their rate as a tensor, vsr.make_optimizer)."""
    hyper = tuple(repr(sorted((k, v) for k, v in g.items() if k != "params" and not isinstance(v, torch.Tensor)))
                  for v in _fields(state) if isinstance(v, torch.optim.Optimizer) for g in v.param_groups)
    return tuple((t.data_ptr(), t.shape, t.dtype) for t in tensors), hyper


class _Graph:
    """One captured body: its graph, the static buffers of its inputs'
    leaves, its logs as (clone after replay, value) slots, the launch
    counts one run adds, and the gradients it leaves on the parameters."""

    def __init__(self, graph, statics: list, out_struct, slots: list, counts: list, dev: torch.device,
                 params: list, grads: list):
        self.graph, self.statics, self.out_struct, self.slots, self.counts, self.dev = (
            graph, statics, out_struct, slots, counts, dev)
        self.params, self.grads = params, grads

    def replay(self, leaves: list):
        _fill([(buf, x) for buf, x in zip(self.statics, leaves) if buf is not None])
        with torch.cuda.device(self.dev):
            self.graph.replay()
        _add_counters(self.counts)
        # the gradients this graph wrote, which it keeps allocated, as the
        # leaves' .grad (an eager call or another graph set others)
        if any(p.grad is not g for p, g in zip(self.params, self.grads)):
            for p, g in zip(self.params, self.grads):
                p.grad = g
        return self.result()

    def result(self):
        return _unflatten(self.out_struct, iter(v.clone() if fresh else v for fresh, v in self.slots))


class TrainStepCache:
    """A train step compiled per input signature, the counterpart of
    `jax.jit(train_step)`: `cache(state, *batch) -> (state, logs)` as the
    step it wraps (an eager_step, or any function with a `.split`).

    The signature follows the JAX rule over the body's inputs (the
    prologue's output: each tensor leaf's shape, dtype and device, any
    other leaf's repr); on the card it adds the state's: where each of
    its tensors lies and the optimizers' settings.  So another state, or
    one whose tensors a load replaced, is another signature, never a
    stale graph (train/checkpoint.py loads in place, which keeps the
    graphs).

    On CPU tensors a call runs the body eagerly.  On CUDA tensors (the
    inputs' and the state's, all on one device, else ValueError):
    - the first call of a signature runs the body eagerly on the pool's
      side stream (it builds the kernels and lets cuDNN and cuBLAS set
      up, so that none of this happens under capture);
    - the second captures the body into a torch.cuda.CUDAGraph (the
      gradients set to None first, so backward allocates them from the
      graph's pool and each replay overwrites them, never adds to the
      last step's) and replays it;
    - every later call copies the inputs into their static buffers and
      replays.
    The first MAX_GRAPHS signatures that recur are captured; any other
    runs eagerly.  An epoch's last partial batch, a shape seen once an
    epoch, runs eagerly in the first epoch, is captured in the second and
    replays after (JAX compiles it once).  A capture or replay that fails
    raises: nothing turns the graphs off.

    A graph keeps the gradients it wrote and sets them as the leaves'
    `.grad` after each replay, as the eager step leaves its own.  The
    kernel wrappers' launch counters stay exact (a replay adds what its
    capture counted).  `eager` is the step it wraps and `split` its
    three parts; the driver runs TrainStepCache(step) where the JAX
    driver runs jax.jit(step).  A step's `loss_fn` and `schedule`, where
    it has them (train.vsr.make_train_step), pass through, as a jitted
    function is transparent to parallel.make_sharded_train_step."""

    def __init__(self, step: Callable):
        self.eager = step
        self._split: SplitStep = step.split
        for name in ("loss_fn", "schedule"):
            if hasattr(step, name):
                setattr(self, name, getattr(step, name))
        self._pool = GraphPool()
        self._seen: set = set()
        self._warmed: set = set()
        self._graphs: dict = {}

    def __call__(self, state, *batch):
        inputs = self._split.prologue(state, *batch)
        logs = self._body(state, inputs)
        self._split.epilogue(state)
        return state, logs

    @property
    def split(self) -> SplitStep:
        return self._split

    @property
    def num_signatures(self) -> int:
        return len(self._seen)

    @property
    def num_graphs(self) -> int:
        return len(self._graphs)

    def _body(self, state, inputs: tuple):
        leaves: list = []
        struct = _flatten(inputs, leaves)
        fixed = state_tensors(state)
        dev = _graph_device(leaves + fixed)
        sig = (struct, tuple(_leaf_sig(x) for x in leaves))
        if dev is None:
            # nothing is captured: the JAX rule alone (a plain optimizer
            # makes its state at its first update)
            self._seen.add(sig)
            return self._split.body(state, *inputs)
        sig += (_state_sig(state, fixed),)
        self._seen.add(sig)
        graph = self._graphs.get(sig)
        if graph is not None:
            return graph.replay(leaves)
        if len(self._graphs) >= MAX_GRAPHS:
            return self._split.body(state, *inputs)
        if sig not in self._warmed:
            self._warmed.add(sig)
            return self._warm_up(dev, state, inputs)
        graph = self._graphs[sig] = self._capture(dev, state, inputs, struct, leaves)
        return graph.result()

    def _warm_up(self, dev: torch.device, state, inputs: tuple):
        main, side = torch.cuda.current_stream(dev), self._pool.stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logs = self._split.body(state, *inputs)
        main.wait_stream(side)
        # made on the side stream, read on the main one
        out: list = []
        _flatten(logs, out)
        for t in out:
            if isinstance(t, torch.Tensor):
                t.record_stream(main)
        return logs

    def _capture(self, dev: torch.device, state, inputs: tuple, struct, leaves: list) -> _Graph:
        statics = [s for arg in self._pool.statics(tuple(inputs), ()) for s in arg]
        params = [p for v in _fields(state) if isinstance(v, (dict, list)) for p in param_leaves(v)]
        with torch.cuda.device(dev):
            _fill([(buf, x) for buf, x in zip(statics, leaves) if buf is not None])
            static_inputs = _unflatten(struct, iter(x if s is None else s for s, x in zip(statics, leaves)))
            graph = torch.cuda.CUDAGraph()
            before = _read_counters()
            # as ShapeCache._capture: nothing is freed under capture, so the
            # blocks other pools hold are returned first
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            for p in params:
                p.grad = None
            with torch.cuda.stream(self._pool.stream(dev)):
                graph.capture_begin(self._pool.handle(dev), capture_error_mode="thread_local")
                try:
                    logs = self._split.body(state, *static_inputs)
                finally:
                    graph.capture_end()
            out: list = []
            out_struct = _flatten(logs, out)
            slots = [(True, x) if isinstance(x, torch.Tensor) else (False, x) for x in out]
            captured = _Graph(graph, statics, out_struct, slots, _counter_delta(before, _read_counters()), dev,
                              params, [p.grad for p in params])
            graph.replay()
        return captured
