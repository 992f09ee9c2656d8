"""The sharded serving factories' compiled forms (parallel/sharded.py's
_BandCaches), on the CPU: every band's device-local phases go through
ShapeCaches of its own, keyed per signature as the JAX factories key
their executables per frame shape, and the factories give what their
eager reference (sharded._eager_reference) and the JAX factories give.

On the CPU a ShapeCache runs its function eagerly, so the graphs
themselves are held on the card (tests/test_torch_parallel_graphs_cuda.py
and chip_smoke phase 15).  Here: the routing (one cache per band and
phase, each band its own static buffers, one pool a factory), the
signatures (the JAX factory's frame-shape keys; the warm denoise step
keyed by its ring phase, 8/T a band, with the frame index never in a
signature), and the outputs and states, bit for bit against the eager
reference and, against the JAX factories on the conftest's 8 virtual
devices, within test_torch_parallel.py's tolerances: uint8 within 1,
state leaves within 1e-4."""

import contextlib
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu import parallel as jpar
from sharkshark_tpu.models import bsvd as jbsvd
from sharkshark_tpu.models import egvsr as jegvsr
from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu.upscale import steps as jsteps
from sharkshark_tpu_torch import parallel as par
from sharkshark_tpu_torch.models import bsvd, egvsr, srvgg
from sharkshark_tpu_torch.parallel import _bands
from sharkshark_tpu_torch.parallel import sharded as sharded_mod
from sharkshark_tpu_torch.upscale import ShapeCache, steps
from sharkshark_tpu_torch.upscale.jit_cache import GraphPool
from sharkshark_tpu_torch.upscale.service import EgvsrUpscalerService, EsrganUpscalerService

CPU = torch.device("cpu")
TINY_J = jsrvgg.SRVGGConfig(num_feat=16, num_conv=2)
TINY = srvgg.SRVGGConfig(num_feat=16, num_conv=2)
BSVD_J = jbsvd.BSVDConfig(chns=(8, 16, 32), mid_ch=8, in_ch=4, out_ch=3, interm_ch=6)
BSVD_T = bsvd.BSVDConfig(chns=(8, 16, 32), mid_ch=8, in_ch=4, out_ch=3, interm_ch=6)
EG_J = jegvsr.EGVSRConfig(nf=16, nb=1)
EG_T = egvsr.EGVSRConfig(nf=16, nb=1)
DEN_LR, DEN_OUT = (8, 256), (16, 512)
EG_LR, EG_OUT = (8, 256), (32, 1024)


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _u8_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, (got.shape, want.shape)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def _equal(got, want):
    """Bit for bit: tensors, or (nested) states whole or sharded."""
    a, b = _bands._leaves(par.gather_state(got)), _bands._leaves(par.gather_state(want))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _leaves_close(got, want, atol=1e-4):
    g = [np.asarray(x, np.float32) for x in jax.tree.leaves(got)]
    w = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _port_state(state):
    whole = par.gather_state(state)
    if isinstance(whole, dict):
        return bsvd.state_to_numpy(whole)
    return tuple(t.numpy() for t in whole)


def _jax_keys(jfn) -> set:
    """The frame shapes the JAX factory has compiled for (its `compiled`
    dict, a cell of the returned function's closure)."""
    cells = dict(zip(jfn.__code__.co_freevars, jfn.__closure__))
    return set(cells["compiled"].cell_contents)


def _specs(lr, out, pix_fmt="rgb24"):
    kw = dict(lr_shape=lr, output_shape=out, denoise_rate=0.75, pix_fmt=pix_fmt)
    return (jsteps.UpscaleSpec(compute_dtype=jnp.float32, **kw),
            steps.UpscaleSpec(compute_dtype=torch.float32, **kw))


def _j_apply(p, x):
    return jsrvgg.apply(p, x, cfg=TINY_J)


def _t_apply(p, x):
    return srvgg.apply(p, x, cfg=TINY)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The bands' many small ops run on one intra-op thread (as in
    test_torch_parallel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sr_params():
    tp = srvgg.init_params(torch.Generator().manual_seed(0), TINY)
    return _np(tp), tp


@pytest.fixture(scope="module")
def den_params(sr_params):
    tp = {"sr": sr_params[1], "denoise": bsvd.init_params(torch.Generator().manual_seed(1), BSVD_T)}
    return _np(tp), tp


@pytest.fixture(scope="module")
def eg_params():
    tp = egvsr.init_params(torch.Generator().manual_seed(0), EG_T)
    return _np(tp), tp


def _mesh(n=8, spatial=2):
    return par.make_mesh(devices=[CPU] * n, spatial=spatial)


def _make(kind, eager=False, pool=None):
    """A factory of `kind` on [cpu] * 8 (made inside the eager reference's
    block where `eager`), and its spec."""
    halo = par.denoise_radius(TINY, BSVD_T)
    with sharded_mod._eager_reference() if eager else contextlib.nullcontext():
        if kind == "upscale":
            _, spec = _specs((32, 128), (64, 256))
            fn = par.make_sharded_upscale(_t_apply, spec, _mesh(8, 2), halo=par.upscale_radius(TINY, 4))
            return fn, spec
        if kind == "egvsr":
            _, spec = _specs(EG_LR, EG_OUT)
            return par.make_sharded_egvsr_step(spec, _mesh(8, 8), EG_T, cut_threshold=0.12), spec
        _, spec = _specs(DEN_LR, DEN_OUT)
        if kind == "flush":
            return par.make_sharded_denoise_flush(_t_apply, spec, _mesh(8, 2), BSVD_T, halo=halo, pool=pool), spec
        return par.make_sharded_denoise(_t_apply, spec, _mesh(8, 2), BSVD_T, warm=kind == "warm", halo=halo,
                                        pool=pool), spec


def _call(kind, fn, spec, params, state=None, seed=0):
    if kind == "upscale":
        return fn(params["sr"], torch.from_numpy(_frames(seed, (4, 32, 128, 3)))), None
    if kind == "egvsr":
        state = state if state is not None else egvsr.init_recurrent_state(1, *EG_LR, EG_T)
        return fn(params, state, torch.from_numpy(_frames(seed, (1, *EG_LR, 3))))
    state = state if state is not None else steps.init_denoise_state(1, spec, BSVD_T)
    frames = torch.from_numpy(_frames(seed, (4, *DEN_LR, 3)))
    if kind == "flush":
        return fn(params, state, frames, 40)
    return fn(params, state, frames)


PHASES = {"upscale": ("local", "finish"), "cold": ("front", "finish"), "warm": ("front", "finish"),
          "flush": ("front", "finish"), "egvsr": ("flow", "sr")}


# ------------------------------------------------------------- routing


@pytest.mark.parametrize("kind", ["upscale", "cold", "flush", "egvsr"])
def test_every_band_runs_its_phases_through_caches_of_its_own(den_params, eg_params, kind, monkeypatch):
    """One ShapeCache per (phase, band): each band's device-local phases
    are called through it, tagged with the band's position, all on the
    factory's one GraphPool."""
    params = eg_params[1] if kind == "egvsr" else den_params[1]
    calls = []
    init = ShapeCache.__call__

    def spy(self, *args):
        calls.append(self)
        return init(self, *args)

    monkeypatch.setattr(ShapeCache, "__call__", spy)
    fn, spec = _make(kind)
    out, state = _call(kind, fn, spec, params)
    caches = fn.band_caches
    # [cpu] * 8 splits into 8 bands (4 a data row for the SR-only step)
    positions = [(r, k) for r in range(4) for k in range(2)] if kind == "upscale" else list(range(8))
    assert set(caches) == {(ph, pos) for ph in PHASES[kind] for pos in positions}
    assert all(isinstance(c, ShapeCache) for c in caches.values())
    assert len({id(c) for c in caches.values()}) == len(caches)
    assert all(c._tag == pos for (_, pos), c in caches.items())
    assert len({id(c._pool) for c in caches.values()}) == 1
    # every cache called once, each with a signature of its own
    assert sorted(map(id, calls)) == sorted(map(id, caches.values()))
    assert all(c.num_signatures == 1 and c.num_graphs == 0 for c in caches.values())


def test_equal_width_bands_keep_their_own_state_buffers(den_params):
    """Two bands of equal width on one device have equal signatures; their
    front caches (the donated state) still get distinct static buffers,
    while the cold and warm caches of one band (a service's shared pool)
    get the same ones, so the state passes between them in place."""
    tp = den_params[1]
    pool = GraphPool()
    cold, spec = _make("cold", pool=pool)
    warm, _ = _make("warm", pool=pool)
    _, sh = _call("cold", cold, spec, tp)
    widths = [b.hi - b.lo for b in sh.bands]
    j, k = next((j, k) for j in range(len(widths)) for k in range(j + 1, len(widths)) if widths[j] == widths[k])
    frames = torch.from_numpy(_frames(1, (4, *DEN_LR, 3)))

    def buffers(fn, pos):
        cache = fn.band_caches[("front", pos)]
        band = sh.bands[pos]
        x = frames[:, :, band.lo : band.hi]
        args = (tp, sharded_mod._untimed(sh.parts[pos]), x, 4, sharded_mod._band_spec(spec, band, DEN_LR[1]))
        per_arg = pool.statics(args, cache._donate, cache._fixed, cache._tag)
        return [b for b in per_arg[1] if b is not None]

    _call("warm", warm, spec, tp, sh, seed=2)
    bj, bk, bj_warm = buffers(cold, j), buffers(cold, k), buffers(warm, j)
    assert bj and len(bj) == len(bk)
    assert not {b.data_ptr() for b in bj} & {b.data_ptr() for b in bk}
    assert [b.data_ptr() for b in bj] == [b.data_ptr() for b in bj_warm]


def test_the_eager_reference_holds_no_cache(den_params):
    """Factories made inside sharded._eager_reference() call their bands'
    phases directly; the block ends with the default restored."""
    tp = den_params[1]
    fn, spec = _make("cold", eager=True)
    assert not sharded_mod._EAGER[0]
    _call("cold", fn, spec, tp)
    assert fn.band_caches == {}
    assert not _make("cold")[0].band_caches  # made outside: caches at the first call
    with pytest.raises(RuntimeError):
        with sharded_mod._eager_reference():
            raise RuntimeError("inside")
    assert not sharded_mod._EAGER[0]


# ------------------------------------------------- signatures and values


def test_sharded_upscale_signatures_and_outputs(sr_params):
    """Two frame shapes (batch 4 and 8) through the 4x2 mesh: the JAX
    factory compiles one executable each, every band's caches see one
    signature each; the outputs equal the eager reference's bit for bit
    and the JAX factory's within 1."""
    jp, tp = sr_params
    jspec, tspec = _specs((32, 128), (64, 256))
    jmesh = jpar.make_mesh(8, spatial=2)
    jfn = jpar.make_sharded_upscale(_j_apply, jspec, jmesh)
    halo = par.upscale_radius(TINY, 4)
    fn = par.make_sharded_upscale(_t_apply, tspec, _mesh(8, 2), halo=halo)
    with sharded_mod._eager_reference():
        ref = par.make_sharded_upscale(_t_apply, tspec, _mesh(8, 2), halo=halo)
    for i, n in enumerate((4, 8, 4)):
        frames = _frames(30 + i, (n, 32, 128, 3))
        with jmesh:
            want = jfn(jp, jax.device_put(jnp.asarray(frames), jpar.batch_sharding(jmesh)))
        got = fn(tp, torch.from_numpy(frames))
        _equal(got, ref(tp, torch.from_numpy(frames)))
        _u8_close(got, want)
    assert jfn._cache_size() == 2
    assert {c.num_signatures for c in fn.band_caches.values()} == {2}


@pytest.mark.parametrize("t, sub", [(4, None), (8, 4)])
def test_sharded_denoise_signatures_and_outputs(den_params, t, sub):
    """A stream through the cold, warm and flush factories (one pool, as a
    service builds them): per band, the cold and flush caches hold one
    signature a chunk (keyed by the frame index, as the single-device
    service's), the warm cache 8/T (its ring phase; the frame index is in
    no signature, and the donated state carries none), each JAX factory
    one executable a frame shape.  Outputs and states equal the eager
    reference's bit for bit and the JAX factories' within 1 and 1e-4."""
    jp, tp = den_params
    jspec, tspec = _specs(DEN_LR, DEN_OUT)
    halo = par.denoise_radius(TINY, BSVD_T)
    jmesh = jpar.make_mesh(8, spatial=2)

    def factories():
        pool = GraphPool()
        kw = dict(halo=halo, pool=pool)
        return (par.make_sharded_denoise(_t_apply, tspec, _mesh(), BSVD_T, sr_sub_batch=sub, **kw),
                par.make_sharded_denoise(_t_apply, tspec, _mesh(), BSVD_T, warm=True, sr_sub_batch=sub, **kw),
                par.make_sharded_denoise_flush(_t_apply, tspec, _mesh(), BSVD_T, **kw))

    graphs = factories()
    with sharded_mod._eager_reference():
        eager = factories()
    jfns = (jpar.make_sharded_denoise(_j_apply, jspec, jmesh, BSVD_J, sr_sub_batch=sub),
            jpar.make_sharded_denoise(_j_apply, jspec, jmesh, BSVD_J, warm=True, sr_sub_batch=sub),
            jpar.make_sharded_denoise_flush(_j_apply, jspec, jmesh, BSVD_J))
    frames = _frames(40 + t, (48, *DEN_LR, 3))
    n_cold, n_warm = bsvd.SHIFT_NUM // t, 32 // t
    g_state = e_state = steps.init_denoise_state(1, tspec, BSVD_T)
    j_state = jsteps.init_denoise_state(1, jspec, BSVD_J)
    with jmesh:
        for i in range(n_cold + n_warm):
            w = int(i >= n_cold)
            x = frames[i * t : (i + 1) * t]
            g_out, g_state = graphs[w](tp, g_state, torch.from_numpy(x))
            e_out, e_state = eager[w](tp, e_state, torch.from_numpy(x))
            j_out, j_state = jfns[w](jp, j_state, jnp.asarray(x))
            _equal(g_out, e_out)
            _equal(g_state, e_state)
            _u8_close(g_out, j_out)
        _leaves_close(_port_state(g_state), jax.tree.map(np.asarray, j_state))
        g_state = g_state.map(lambda s: bsvd.ring_to_fifo_state(s, BSVD_T))
        e_state = e_state.map(lambda s: bsvd.ring_to_fifo_state(s, BSVD_T))
        j_state = jbsvd.ring_to_fifo_state(j_state, BSVD_J)
        t_end = n_cold * t + n_warm * t
        for i in range(0, bsvd.SHIFT_NUM, 4):
            tail = frames[t_end - bsvd.SHIFT_NUM + i :][:4]
            g_out, g_state = graphs[2](tp, g_state, torch.from_numpy(tail), t_end)
            e_out, e_state = eager[2](tp, e_state, torch.from_numpy(tail), t_end)
            j_out, j_state = jfns[2](jp, j_state, jnp.asarray(tail), jnp.asarray(t_end, jnp.int32))
            _equal(g_out, e_out)
            _u8_close(g_out, j_out)
    _equal(g_state, e_state)
    _leaves_close(_port_state(g_state), jax.tree.map(np.asarray, j_state))
    assert par.gather_state(g_state)["t"] == t_end + bsvd.SHIFT_NUM
    assert [len(_jax_keys(j)) for j in jfns] == [1, 1, 1]
    cold, warm, flush = (f.band_caches for f in graphs)
    for pos in range(len(g_state.bands)):
        assert cold[("front", pos)].num_signatures == n_cold
        assert warm[("front", pos)].num_signatures == 8 // t
        assert flush[("front", pos)].num_signatures == bsvd.SHIFT_NUM // 4
        for cache in (cold[("front", pos)], warm[("front", pos)], flush[("front", pos)]):
            for struct, _ in cache._seen:
                # the donated argument (position 1) is a dict without "t"
                kind, items = struct[1][1]
                assert kind is dict and "t" not in dict(items)


@pytest.mark.parametrize("cut", [None, 0.12])
def test_sharded_egvsr_signatures_and_outputs(eg_params, cut):
    """Three frames (the third a scene cut) through the 1x8 step: one
    signature a band and phase, as the JAX factory's one executable;
    outputs and state equal the eager reference's bit for bit and the
    JAX factory's within 1 and 1e-4."""
    jp, tp = eg_params
    jspec, tspec = _specs(EG_LR, EG_OUT)
    frames = _frames(7, (3, *EG_LR, 3))
    frames[2] = 255 - frames[2]
    jmesh = jpar.make_mesh(8, spatial=8)
    jfn = jpar.make_sharded_egvsr_step(jspec, jmesh, EG_J, cut_threshold=cut)
    fn = par.make_sharded_egvsr_step(tspec, _mesh(8, 8), EG_T, cut_threshold=cut)
    with sharded_mod._eager_reference():
        ref = par.make_sharded_egvsr_step(tspec, _mesh(8, 8), EG_T, cut_threshold=cut)
    js = jegvsr.init_recurrent_state(1, *EG_LR, EG_J)
    gs = es = egvsr.init_recurrent_state(1, *EG_LR, EG_T)
    for i in range(3):
        x = frames[i : i + 1]
        with jmesh:
            jo, js = jfn(jp, js, jnp.asarray(x))
        go, gs = fn(tp, gs, torch.from_numpy(x))
        eo, es = ref(tp, es, torch.from_numpy(x))
        _equal(go, eo)
        _equal(gs, es)
        _u8_close(go, jo)
    _leaves_close(_port_state(gs), tuple(np.asarray(x) for x in js))
    assert len(_jax_keys(jfn)) == 1
    assert len(fn.band_caches) == 2 * len(gs.bands)
    assert {c.num_signatures for c in fn.band_caches.values()} == {1}


# ------------------------------------------------------------ services


def test_mesh_service_shares_one_pool_and_close_frees_the_factories(den_params):
    """The denoise service on a mesh builds its cold, warm and flush
    factories on one GraphPool; close() drops them (and the sharded
    state), so their caches go at once, without the cycle collector; a
    dropped service takes them with it too."""
    tp = den_params[1]

    def make():
        svc = EsrganUpscalerService(denoising=True, batch_size=4, output_shape=DEN_OUT, mesh=_mesh(),
                                    compute_dtype=torch.float32, srvgg_cfg=TINY, bsvd_cfg=BSVD_T, device="cpu")
        svc.lr_shape = DEN_LR
        svc.proc_init()
        svc._params, svc._sr_params = tp, tp["sr"]
        return svc

    frames = _frames(3, (24, *DEN_LR, 3))
    gc.collect()
    gc.disable()
    try:
        for drop in ("close", "del"):
            svc = make()
            for i in range(0, 24, 4):
                svc.upscale(frames[i : i + 4])
            factories = [*svc._sharded_denoise.values(), svc._sharded_flush]
            caches = [c for f in factories for c in f.band_caches.values()]
            assert caches and len({id(c._pool) for c in caches}) == 1
            refs = [weakref.ref(c) for c in caches] + [weakref.ref(caches[0]._pool)]
            del factories, caches
            if drop == "close":
                svc.close()
                assert not any(n.startswith("_sharded_") for n in vars(svc)) and not hasattr(svc, "_den_state")
            else:
                del svc
            assert [r() is None for r in refs] == [True] * len(refs), drop
    finally:
        gc.enable()


def test_mesh_egvsr_service_close_frees_its_step(eg_params):
    tp = eg_params[1]
    svc = EgvsrUpscalerService(output_shape=EG_OUT, mesh=_mesh(8, 8), cut_threshold=None,
                               compute_dtype=torch.float32, cfg=EG_T, device="cpu")
    svc.lr_shape = EG_LR
    svc.proc_init()
    svc._params = tp
    before = svc.upscale(_frames(4, (2, *EG_LR, 3)))
    ref = weakref.ref(next(iter(svc._step.band_caches.values())))
    svc.close()
    assert ref() is None and not hasattr(svc, "_step")
    svc.proc_init()
    svc._params = tp
    np.testing.assert_array_equal(svc.upscale(_frames(4, (2, *EG_LR, 3))), before)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 3])
def test_warm_index_keys_the_ring_phase(n):
    """steps._warm_index, the warm step's key in the single-device service
    and the sharded factory: t % 8 past SHIFT_NUM where n divides the
    ring, else one key for every t."""
    keys = {steps._warm_index(t, 8, n) for t in range(bsvd.SHIFT_NUM, bsvd.SHIFT_NUM + 64, n)}
    assert len(keys) == (8 // n if 8 % n == 0 else 1)
    assert all(k >= bsvd.SHIFT_NUM for k in keys)
