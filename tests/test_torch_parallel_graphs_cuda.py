"""The sharded serving factories through their bands' CUDA graphs on the
card, on a mesh that repeats cuda:0 four times (the bands run one after
another on one card, where two bands of equal width have equal
signatures): every replay against the same factory run eagerly
(sharded._eager_reference) on the same inputs, bit for bit (the same
kernels on the same values), for the denoise chunk cold, warm and
flushed over two streams, the SR-only step on a 2x2 mesh and the EGVSR
step on 1x4; the bands' donated states in buffers of their own; the
kernels' launch counters exact across replays.

These tests need an NVIDIA GPU and nvcc, so they carry the `cuda` marker
and skip on a host without CUDA.  On the card, without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_graphs_cuda.py
"""

import numpy as np
import pytest
import torch

from sharkshark_tpu_torch import parallel as par
from sharkshark_tpu_torch.models import bsvd, egvsr, srvgg
from sharkshark_tpu_torch.ops import conv_stack as cs
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.parallel import _bands
from sharkshark_tpu_torch.parallel import sharded as sharded_mod
from sharkshark_tpu_torch.upscale import steps
from sharkshark_tpu_torch.upscale.jit_cache import GraphPool

pytestmark = pytest.mark.cuda

SR_CFG = srvgg.SRVGGConfig(num_conv=4)
EG_CFG = egvsr.EGVSRConfig(nf=32, nb=2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _counts() -> tuple:
    return tsm.launches, dict(tsm.launches_by_device), cs.launches, dict(cs.launches_by_device)


def _delta(before: tuple, after: tuple) -> tuple:
    return tuple({k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)} if isinstance(a, dict) else a - b
                 for b, a in zip(before, after))


def _equal(got, want):
    a, b = _bands._leaves(par.gather_state(got)), _bands._leaves(par.gather_state(want))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
        else:
            assert x == y


def _sr_apply(p, x):
    return srvgg.apply_down_rational(p, x, 2, 1, cfg=SR_CFG, conv_stack=1)


def _denoise_factories(spec, mesh):
    """The cold, warm and flush factories on one pool, as a service builds
    them."""
    kw = dict(halo=par.denoise_radius(SR_CFG), pool=GraphPool())
    return (par.make_sharded_denoise(_sr_apply, spec, mesh, **kw),
            par.make_sharded_denoise(_sr_apply, spec, mesh, warm=True, **kw),
            par.make_sharded_denoise_flush(_sr_apply, spec, mesh, **kw))


def _state_ptrs(state) -> list[set]:
    """Per band, the addresses of its state's tensors."""
    return [{x.data_ptr() for x in _bands._leaves(p) if torch.is_tensor(x)} for p in state.parts]


def test_denoise_replays_equal_eager_and_bands_keep_their_own_state(dev):
    """BSVD-32 (K1) and a 64-feature SRVGG (K4) over four bands of
    cuda:0, two streams of 4 cold, 6 warm and 4 flush chunks: the graphs'
    outputs and states equal the eager factory's bit for bit at every
    chunk, each chunk launches what the eager one launches, the warm step
    holds two graphs a band (ring phases 0 and 4) and the second stream
    captures and replays the cold and flush ones too; from the warm replays on, the
    bands' states lie in buffers of their own, the same at every call."""
    spec = steps.UpscaleSpec(lr_shape=(64, 512), output_shape=(128, 1024), denoise_rate=0.75)
    params = {"sr": srvgg.init_params(torch.Generator().manual_seed(0), SR_CFG, dev),
              "denoise": bsvd.init_params(torch.Generator().manual_seed(1), bsvd.BSVD_32, dev)}
    params = _bands.tree_map(lambda t: t.to(torch.bfloat16), params)
    mesh = par.make_mesh(devices=[dev] * 4, spatial=4)
    graphs = _denoise_factories(spec, mesh)
    with sharded_mod._eager_reference():
        eager = _denoise_factories(spec, mesh)
    rng = np.random.default_rng(3)
    frames = [torch.from_numpy(rng.integers(0, 256, (4, 64, 512, 3), dtype=np.uint8)) for _ in range(10)]
    with torch.inference_mode():
        for stream in range(2):
            g_state = e_state = steps.init_denoise_state(1, spec, device=dev)
            warm_ptrs = []
            for i, x in enumerate(frames):
                w = int(i >= bsvd.SHIFT_NUM // 4)
                before = _counts()
                e_out, e_state = eager[w](params, e_state, x)
                torch.cuda.synchronize()
                want = _delta(before, _counts())
                before = _counts()
                g_out, g_state = graphs[w](params, g_state, x)
                torch.cuda.synchronize()
                assert _delta(before, _counts()) == want, (stream, i)
                assert want[0] > 0 and want[2] > 0
                assert torch.equal(g_out, e_out), (stream, i)
                _equal(g_state, e_state)
                if w and i >= 7:
                    warm_ptrs.append(_state_ptrs(g_state))
            widths = [b.hi - b.lo for b in g_state.bands]
            assert len(set(widths)) < len(widths), "no two bands of equal width"
            ptrs = warm_ptrs[0]
            assert all(p == ptrs for p in warm_ptrs), "the warm replays moved a band's state"
            assert all(not (ptrs[j] & ptrs[k]) for j in range(4) for k in range(j + 1, 4)), \
                "two bands share a state buffer"
            g_state = g_state.map(lambda s: bsvd.ring_to_fifo_state(s))
            e_state = e_state.map(lambda s: bsvd.ring_to_fifo_state(s))
            for x in frames[-4:]:
                before = _counts()
                e_out, e_state = eager[2](params, e_state, x, 40)
                want = _delta(before, _counts())
                before = _counts()
                g_out, g_state = graphs[2](params, g_state, x, 40)
                assert _delta(before, _counts()) == want
                assert torch.equal(g_out, e_out)
                _equal(g_state, e_state)
    # the fronts keyed by the ring phase (warm) or the frame index (cold,
    # flush; captured in the second stream), the finishes by shapes alone
    cold, warm, flush = (f.band_caches for f in graphs)
    for pos in range(4):
        assert warm[("front", pos)].num_graphs == 2
        assert cold[("front", pos)].num_graphs == 4 and flush[("front", pos)].num_graphs == 4
        assert warm[("finish", pos)].num_graphs == cold[("finish", pos)].num_graphs == 1
        assert flush[("finish", pos)].num_graphs == 1
    assert not any(f.band_caches for f in eager)


def test_sr_only_2x2_replays_equal_eager(dev):
    """The SR-only step (K4) with the batch over "data" and W over
    "spatial", four bands on cuda:0: five calls, the third on captured
    graphs; bit for bit and the same launches as the eager factory."""
    spec = steps.UpscaleSpec(lr_shape=(64, 512), output_shape=(128, 1024))
    params = _bands.tree_map(lambda t: t.to(torch.bfloat16),
                             srvgg.init_params(torch.Generator().manual_seed(0), SR_CFG, dev))
    mesh = par.make_mesh(devices=[dev] * 4, data=2, spatial=2)
    kw = dict(halo=par.upscale_radius(SR_CFG, 2))
    fn = par.make_sharded_upscale(_sr_apply, spec, mesh, **kw)
    with sharded_mod._eager_reference():
        ref = par.make_sharded_upscale(_sr_apply, spec, mesh, **kw)
    rng = np.random.default_rng(4)
    with torch.inference_mode():
        for i in range(5):
            x = torch.from_numpy(rng.integers(0, 256, (4, 64, 512, 3), dtype=np.uint8))
            before = _counts()
            want = ref(params, x)
            counted = _delta(before, _counts())
            before = _counts()
            got = fn(params, x)
            assert _delta(before, _counts()) == counted and counted[2] > 0
            assert torch.equal(got, want), i
    assert {c.num_graphs for c in fn.band_caches.values()} == {1}


def test_egvsr_1x4_replays_equal_eager(dev):
    """The EGVSR step over four bands of cuda:0, six frames with the
    scene-cut test (the fifth a cut): bit for bit against the eager
    factory, outputs and state, and no launch of a kernel."""
    spec = steps.UpscaleSpec(lr_shape=(64, 512), output_shape=(128, 1024))
    params = _bands.tree_map(lambda t: t.to(torch.bfloat16),
                             egvsr.init_params(torch.Generator().manual_seed(0), EG_CFG, dev))
    mesh = par.make_mesh(devices=[dev] * 4, spatial=4)
    fn = par.make_sharded_egvsr_step(spec, mesh, EG_CFG, cut_threshold=0.12)
    with sharded_mod._eager_reference():
        ref = par.make_sharded_egvsr_step(spec, mesh, EG_CFG, cut_threshold=0.12)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (6, 64, 512, 3), dtype=np.uint8)
    frames[4] = 255 - frames[4]
    g_state = e_state = egvsr.init_recurrent_state(1, 64, 512, EG_CFG, torch.bfloat16, dev)
    with torch.inference_mode():
        before = _counts()
        for i in range(6):
            x = torch.from_numpy(frames[i : i + 1])
            e_out, e_state = ref(params, e_state, x)
            g_out, g_state = fn(params, g_state, x)
            assert torch.equal(g_out, e_out), i
            _equal(g_state, e_state)
        assert _delta(before, _counts()) == (0, {}, 0, {})
    assert {c.num_graphs for c in fn.band_caches.values()} == {1}
    ptrs = _state_ptrs(g_state)
    assert all(not (ptrs[j] & ptrs[k]) for j in range(4) for k in range(j + 1, 4))
