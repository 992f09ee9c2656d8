"""Per-signature CUDA graphs and the kernels' on-disk build cache
(counterpart of the JAX package's upscale/jit_cache.py).

The JAX package keeps, in process, one compiled executable per input
signature (ShapeCache) and, across processes, XLA's compilation cache on
disk (enable_persistent_cache).  Eager PyTorch compiles nothing per
shape.  What an executable gives its caller is one device program
replayed per shape with no per-op host work; here that is a
torch.cuda.CUDAGraph captured per signature.  On disk, the nvcc-built
kernels (ops/_build.py, one library per source, keyed by the hash of
that source) play the part of XLA's cache.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable

import torch

from ..ops import _build
from ..ops import conv_stack as _conv_stack
from ..ops import tsm_conv as _tsm_conv
from ..ops import warp as _warp

__all__ = ["ShapeCache", "GraphPool", "enable_persistent_cache", "default_cache_dir", "CAPTURE_CALL", "MAX_GRAPHS"]

# the call of a signature that captures its graph: the first runs eagerly
# to build and warm the kernels
CAPTURE_CALL = 2
# graphs a ShapeCache captures at most (see ShapeCache)
MAX_GRAPHS = 8

# the kernel wrappers' launch counters: a replay calls no wrapper, so
# each graph adds at every replay what its capture counted
_COUNTERS = (
    (_tsm_conv, "launches"), (_tsm_conv, "launches_by_device"), (_tsm_conv, "pair_launches"),
    (_conv_stack, "launches"), (_conv_stack, "launches_by_device"), (_warp, "launches"),
)


def default_cache_dir() -> str:
    """$SHARKSHARK_COMPILE_CACHE where it is set (the JAX package's
    variable), else this package's build/ directory, where the kernels
    build by default."""
    return os.environ.get("SHARKSHARK_COMPILE_CACHE", str(_build.PKG / "build"))


def enable_persistent_cache(path: str | None = None) -> str:
    """Keep the nvcc-built kernels in `path` (default_cache_dir()):
    create it, point ops/_build.py's build directory at it and return it
    (idempotent).  A library there is keyed by the hash of its source and
    flags, so a restarted process loads it instead of running nvcc, as
    XLA's on-disk cache spares the JAX package its compiles; nothing is
    compiled per shape."""
    path = os.path.abspath(path or default_cache_dir())
    os.makedirs(path, exist_ok=True)
    _build.BUILD = Path(path)
    return path


def _flatten(tree, leaves: list):
    """Append the leaves of nested dicts, tuples and lists to `leaves`;
    return the structure, hashable."""
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    leaves.append(tree)
    return None


def _unflatten(struct, leaves):
    """The tree of `struct` (from _flatten) over the iterator `leaves`."""
    if struct is None:
        return next(leaves)
    kind, items = struct
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in items}
    values = [_unflatten(s, leaves) for s in items]
    return kind(*values) if hasattr(kind, "_fields") else kind(values)


def _leaf_sig(x: Any) -> tuple:
    if isinstance(x, torch.Tensor):
        return (x.shape, x.dtype, x.device)
    return ("static", repr(x))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.stride() == b.stride() and a.dtype == b.dtype


def _fill(pairs: list) -> None:
    """Copy each (destination, source) pair's source in, skipping a source
    that is its destination already; a source that shares memory with any
    destination is copied aside first, so no copy reads what another
    wrote."""
    pairs = [(d, s) for d, s in pairs if not _same(d, s)]
    if not pairs:
        return
    targets = {_storage(d) for d, _ in pairs}
    torch._foreach_copy_([d for d, _ in pairs], [s.clone() if _storage(s) in targets else s for _, s in pairs])


def _read_counters() -> list:
    return [dict(v) if isinstance(v := getattr(m, n), dict) else v for m, n in _COUNTERS]


def _counter_delta(before: list, after: list) -> list:
    return [{k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)} if isinstance(a, dict) else a - b
            for b, a in zip(before, after)]


def _add_counters(delta: list) -> None:
    for (module, name), d in zip(_COUNTERS, delta):
        if isinstance(d, dict):
            counts = getattr(module, name)
            for k, v in d.items():
                counts[k] = counts.get(k, 0) + v
        elif d:
            setattr(module, name, getattr(module, name) + d)


class GraphPool:
    """What the graphs of several ShapeCaches share: one CUDA graph memory
    pool and one side stream per device, and the static input buffers.

    The graphs of one service replay one at a time on one stream, and
    nothing they leave in the pool outlives its replay: a non-donated
    output is cloned out at once, and a donated one is written into its
    static buffer, which lies outside the pool.  So a later capture may
    reuse what an earlier graph freed, whatever the order of the replays,
    and the pool holds about one step's temporaries, not one a graph.

    A static buffer is kept per (the cache's tag, argument position,
    donated or not, structure, tensor shapes and dtypes): the graphs of
    every cache of one tag that shares the pool read a donated argument
    of that structure from the same tensors, so a step's state passes
    from one graph to the next without a copy (the denoise steps' cold,
    warm and flush graphs).  Caches of other tags keep their own buffers:
    the bands of a mesh (parallel/sharded.py), two of which may have
    equal shapes on one device and must not share a state.  Buffers are
    made at a capture only, so they are as bounded as the graphs
    (MAX_GRAPHS a cache).  All of it is freed when the last cache and
    graph that refer to the pool are dropped."""

    def __init__(self) -> None:
        self._handles: dict = {}
        self._streams: dict = {}
        self._statics: dict = {}

    def handle(self, dev: torch.device):
        if dev not in self._handles:
            self._handles[dev] = torch.cuda.graph_pool_handle()
        return self._handles[dev]

    def stream(self, dev: torch.device) -> torch.cuda.Stream:
        """The side stream that warm-ups and captures run on."""
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def statics(self, args: tuple, donated: tuple, fixed: tuple = (), tag: Any = None) -> list[list]:
        """Per argument, its static buffers (None at a non-tensor leaf, and
        at every leaf of a fixed argument, which is read where it lies),
        those of the caches tagged `tag`."""
        out = []
        for i, a in enumerate(args):
            leaves: list = []
            struct = _flatten(a, leaves)
            if i in fixed:
                out.append([None] * len(leaves))
                continue
            key = (tag, i, i in donated, struct,
                   tuple(_leaf_sig(x) if isinstance(x, torch.Tensor) else None for x in leaves))
            if key not in self._statics:
                # plain tensors, which a call in or out of inference mode
                # may write
                with torch.inference_mode(False):
                    self._statics[key] = [torch.empty_like(x, memory_format=torch.contiguous_format)
                                          if isinstance(x, torch.Tensor) else None for x in leaves]
            out.append(self._statics[key])
        return out


class _Graph:
    """One captured signature: its graph, the static buffers of its
    arguments' leaves, the addresses of its fixed arguments' tensors by
    leaf index, its outputs as (clone after replay, value) slots, and the
    launch counts that one run adds."""

    def __init__(self, graph, statics: list, fixed: dict, out_struct, slots: list, counts: list,
                 dev: torch.device):
        self.graph, self.statics, self.fixed, self.out_struct, self.slots, self.counts, self.dev = (
            graph, statics, fixed, out_struct, slots, counts, dev)

    def replay(self, leaves: list):
        if any(leaves[j].data_ptr() != ptr for j, ptr in self.fixed.items()):
            raise ValueError("ShapeCache: a fixed argument must be the same tensors at every call of a signature")
        _fill([(buf, x) for buf, x in zip(self.statics, leaves) if buf is not None])
        with torch.cuda.device(self.dev):
            self.graph.replay()
        _add_counters(self.counts)
        return self.result()

    def result(self):
        return _unflatten(self.out_struct, iter(v.clone() if fresh else v for fresh, v in self.slots))


def _graph_device(leaves: list) -> torch.device | None:
    """The CUDA device of a call's tensors, None if none lies on one."""
    devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
    if not any(d.type == "cuda" for d in devices):
        return None
    if len(devices) > 1:
        raise ValueError(f"ShapeCache: the tensors of one call must lie on one CUDA device, got {devices}")
    return next(iter(devices))


class ShapeCache:
    """Per-input-signature CUDA graph cache, the counterpart of the JAX
    package's per-signature jitted executables.

    The signature follows the JAX rule: a tensor leaf of the arguments
    (nested dicts, tuples and lists) gives its shape and dtype, and here
    its device; any other leaf gives its repr.  `num_signatures` counts
    the signatures seen, `num_graphs` those captured.

    On CPU tensors, or with grad enabled, a call records its signature
    and runs `fn` eagerly.  On CUDA tensors (all on one device, else
    ValueError):
    - the first call of a signature runs `fn` eagerly on the pool's side
      stream: it builds the kernels, sets their shared-memory opt-in,
      makes the per-device constants and lets cuDNN choose, so that none
      of this happens under capture;
    - the second (CAPTURE_CALL) copies the arguments' tensors into static
      buffers, captures `fn` into a torch.cuda.CUDAGraph and replays it;
    - every later call copies the arguments' tensors into those buffers
      and replays.  No copy is made of a tensor that is its buffer (a
      donated state passed back).
    A signature seen once is never captured: a step keyed by a host int
    that changes at every call (a frame index) runs eagerly.  A capture
    or replay that fails raises; nothing turns the graphs off.  The graph
    freezes every address that its kernels read and write, which is why
    the arguments pass through static buffers.

    MAX_GRAPHS bounds what the cache holds on the device: a graph pins its
    outputs in the pool and its arguments' static buffers for as long as
    it is kept, and each capture synchronizes the device.  The first
    MAX_GRAPHS signatures that recur are captured and kept; any other
    runs eagerly, by design.  A streaming step's signatures are few and
    come first (at micro-batch 4: two warm, four cold, four flush chunks
    a stream length); an image service's buckets beyond the cap, which
    would otherwise each hold a graph for good, run as eager PyTorch.

    donate_argnums, the counterpart of JAX's buffer donation: `fn` then
    returns a tuple whose last len(donate_argnums) items are the new
    values of those arguments (a step's state), each of its argument's
    structure, shapes and dtypes.  Inside the captured region they are
    written into the argument's static buffers (a leaf that `fn` updated
    in place is its buffer already), and the cache returns those buffers:
    passed back, they are not copied again.  They stay valid until the
    next call of a graph that shares them (GraphPool).  Any other output
    tensor is cloned after the replay, so it stays valid after the next
    call, as a JAX output does.

    The launch counters of the kernel wrappers (ops/tsm_conv.py,
    ops/conv_stack.py, ops/warp.py) stay exact: a capture records how
    much each grew and a replay adds that again.

    fixed_argnums: arguments whose tensors the graph reads where they lie,
    with no static buffer and no copy: a service's weights, passed as the
    same tensors at every call.  A replay checks their addresses (other
    tensors raise ValueError); a write into them in place is seen by the
    next replay.  (On an H100, copying the warm denoise step's ~170 weight
    tensors at every replay added ~1.2 host ms to its ~1.8.)

    pool: a GraphPool that several caches share (one service's); by
    default the cache's graphs share one of their own.  Dropping the
    cache (and the pool, where shared) frees its graphs, their pool and
    their static buffers.

    tag: which of the pool's static buffers the cache uses; caches share
    them only where their tags are equal (GraphPool).  A sharded factory
    tags each band's caches with the band's position."""

    def __init__(self, fn: Callable, *, donate_argnums: tuple[int, ...] = (), fixed_argnums: tuple[int, ...] = (),
                 pool: GraphPool | None = None, tag: Any = None):
        if set(donate_argnums) & set(fixed_argnums):
            raise ValueError("ShapeCache: an argument is either donated or fixed")
        self._fn = fn
        self._donate = tuple(donate_argnums)
        self._fixed = tuple(fixed_argnums)
        self._pool = pool if pool is not None else GraphPool()
        self._tag = tag
        self._seen: set[tuple] = set()
        self._warmed: set[tuple] = set()
        self._graphs: dict[tuple, _Graph] = {}

    def __call__(self, *args):
        leaves: list = []
        struct = _flatten(args, leaves)
        sig = (struct, tuple(_leaf_sig(x) for x in leaves))
        self._seen.add(sig)
        if torch.is_grad_enabled():
            return self._fn(*args)
        graph = self._graphs.get(sig)
        if graph is not None:
            return graph.replay(leaves)
        dev = _graph_device(leaves)
        if dev is None or len(self._graphs) >= MAX_GRAPHS:
            return self._fn(*args)
        if sig not in self._warmed:
            self._warmed.add(sig)
            return self._warm_up(dev, args)
        graph = self._graphs[sig] = self._capture(dev, args, struct, leaves)
        return graph.result()

    @property
    def num_signatures(self) -> int:
        return len(self._seen)

    @property
    def num_graphs(self) -> int:
        return len(self._graphs)

    def _warm_up(self, dev: torch.device, args: tuple):
        main, side = torch.cuda.current_stream(dev), self._pool.stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._fn(*args)
        main.wait_stream(side)
        return out

    def _capture(self, dev: torch.device, args: tuple, struct, leaves: list) -> _Graph:
        per_arg = self._pool.statics(args, self._donate, self._fixed, self._tag)
        statics = [s for arg in per_arg for s in arg]
        fixed_at = [i in self._fixed for i, arg in enumerate(per_arg) for _ in arg]
        fixed = {j: x.data_ptr() for j, x in enumerate(leaves) if fixed_at[j] and isinstance(x, torch.Tensor)}
        with torch.cuda.device(dev):
            _fill([(buf, x) for buf, x in zip(statics, leaves) if buf is not None])
            static_args = _unflatten(struct, iter(x if s is None else s for s, x in zip(statics, leaves)))
            graph = torch.cuda.CUDAGraph()
            before = _read_counters()
            # as torch.cuda.graph does, but keeping the pinned host memory's
            # cache, which the uploads and host copies would pay for again:
            # the capture allocates from its private pool and may free
            # nothing, so the blocks other pools hold are returned first
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            with torch.cuda.stream(self._pool.stream(dev)):
                graph.capture_begin(self._pool.handle(dev), capture_error_mode="thread_local")
                try:
                    out = self._fn(*static_args)
                    out_struct, slots = self._bind(out, static_args, per_arg)
                finally:
                    graph.capture_end()
            captured = _Graph(graph, statics, fixed, out_struct, slots, _counter_delta(before, _read_counters()),
                              dev)
            graph.replay()
        return captured

    def _bind(self, out, args: tuple, per_arg: list[list]):
        """Inside the capture: write the donated arguments' new values into
        their static buffers; return the output's structure and slots."""
        k = len(self._donate)
        if k and (not isinstance(out, tuple) or len(out) < k):
            raise ValueError(f"ShapeCache: with donate_argnums={self._donate}, fn must return a tuple ending "
                             f"in the {k} donated arguments' new values")
        head, tail = (out[: len(out) - k], out[len(out) - k :]) if k else (out, ())
        pairs, tail_slots = [], []
        for i, new in zip(self._donate, tail):
            new_leaves: list = []
            if _flatten(new, new_leaves) != _flatten(args[i], []):
                raise ValueError(f"ShapeCache: the new value of donated argument {i} has another structure")
            for buf, x in zip(per_arg[i], new_leaves):
                if buf is None:
                    if isinstance(x, torch.Tensor):
                        raise ValueError(f"ShapeCache: donated argument {i} gained a tensor leaf")
                    tail_slots.append((False, x))
                    continue
                if not isinstance(x, torch.Tensor) or (x.shape, x.dtype, x.device) != (buf.shape, buf.dtype,
                                                                                         buf.device):
                    raise ValueError(f"ShapeCache: a leaf of donated argument {i} changed its shape, dtype or "
                                     f"device: {_leaf_sig(buf)} -> {_leaf_sig(x)}")
                pairs.append((buf, x))
                tail_slots.append((False, buf))
        written = {_storage(b) for b, x in pairs if not _same(b, x)}
        head_leaves: list = []
        _flatten(head, head_leaves)
        # an output that is (a view of) a buffer about to be written keeps
        # the value it had
        head_slots = [(True, x.clone() if _storage(x) in written else x) if isinstance(x, torch.Tensor)
                      else (False, x) for x in head_leaves]
        _fill(pairs)
        return _flatten(out, []), head_slots + tail_slots
