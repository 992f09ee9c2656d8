"""upscale/jit_cache.py's CUDA graphs on the card: a signature's first
call runs eagerly, its second captures and replays a graph, every later
one replays it; held against the same function run eagerly on K1 (tsm_conv)
K4 (fused_conv_stack) and K3 (backward_warp) calls, bit for bit (the same
kernels on the same inputs).  Also: a donated state updated in place in
its static buffers, an output that stays valid after the next call, the
kernels' launch counters exact after replays, a capture that fails
raising, weights read in place, the cap on the graphs a cache holds, the
memory a dropped cache or a closed service gives back, and the
single-device services through their graphs against the eager steps.

These tests need an NVIDIA GPU and nvcc, so they carry the `cuda` marker
and skip on a host without CUDA.  On the card, without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_jit_cache_cuda.py
"""

import gc

import numpy as np
import pytest
import torch

from sharkshark_tpu_torch.models import bsvd, egvsr, srvgg
from sharkshark_tpu_torch.ops import conv_stack as cs
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.ops import warp as wp
from sharkshark_tpu_torch.upscale import EgvsrUpscalerService, EsrganUpscalerService, ShapeCache, jit_cache, steps

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, dev, *shape, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)


def _kernel_inputs(dev, seed):
    """K1's and K4's arguments at small shapes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k1 = (_randn(g, dev, 4, 1, 20, 36, 64), _randn(g, dev, 1, 20, 36, 64), _randn(g, dev, 1, 20, 36, 8),
          _randn(g, dev, 3, 3, 64, 64, scale=0.05), _randn(g, dev, 64, scale=0.1))
    k4 = (_randn(g, dev, 2, 24, 40, 64), _randn(g, dev, 2, 3, 3, 64, 64, scale=0.05),
          torch.full((2, 64), 0.2, device=dev), torch.randn((2, 64), generator=g, device=dev) * 0.1)
    return k1, k4


def _kernels(k1, k4):
    y1 = tsm.tsm_conv(*k1, "relu6")
    y4 = cs.fused_conv_stack(*k4)
    return y1 * 2, y4 + 1


def test_replay_matches_eager_on_k1_and_k4(dev):
    cache = ShapeCache(_kernels)
    with torch.inference_mode():
        for i in range(5):
            args = _kernel_inputs(dev, i)
            got = cache(*args)
            want = _kernels(*args)
            for a, b in zip(got, want):
                assert torch.equal(a, b), i
            assert cache.num_graphs == (0 if i == 0 else 1)
    assert cache.num_signatures == 1


def _step(p, s, x):
    """A step with a state: an accumulator (a new tensor every call) and a
    ring written in place, through K4."""
    y = cs.fused_conv_stack(x, *p)
    s["ring"][0].copy_(y[0])
    return y[:, :4].float().sum(dim=-1), {"acc": s["acc"] + y, "ring": s["ring"]}


def test_donated_state_lives_in_the_static_buffers(dev):
    g = torch.Generator(device=dev).manual_seed(9)
    p = (_randn(g, dev, 1, 3, 3, 64, 64, scale=0.05), torch.full((1, 64), 0.2, device=dev), None)
    xs = [_randn(g, dev, 2, 16, 24, 64) for _ in range(6)]
    fresh = {"acc": torch.zeros((2, 16, 24, 64), dtype=torch.bfloat16, device=dev),
             "ring": torch.zeros((3, 16, 24, 64), dtype=torch.bfloat16, device=dev)}
    cache = ShapeCache(_step, donate_argnums=(1,))
    with torch.inference_mode():
        ref = {k: v.clone() for k, v in fresh.items()}
        st = {k: v.clone() for k, v in fresh.items()}
        ptrs, outs = [], []
        for x in xs:
            out, st = cache(p, st, x)
            want, ref = _step(p, ref, x)
            assert torch.equal(out, want) and all(torch.equal(st[k], ref[k]) for k in ref)
            ptrs.append({k: v.data_ptr() for k, v in st.items()})
            outs.append((out, want))
        # from the capture on, the state is the static buffers, passed back
        # without a copy; the outputs are fresh tensors, still valid
        assert ptrs[1] == ptrs[2] == ptrs[5]
        assert all(torch.equal(o, w) for o, w in outs)
        # a state that is not the buffers is copied in
        out, st = cache(p, {k: v.clone() for k, v in fresh.items()}, xs[0])
        want, _ = _step(p, {k: v.clone() for k, v in fresh.items()}, xs[0])
        assert torch.equal(out, want) and {k: v.data_ptr() for k, v in st.items()} == ptrs[5]


def test_output_stays_valid_after_the_next_call(dev):
    cache = ShapeCache(_kernels)
    with torch.inference_mode():
        args = [_kernel_inputs(dev, i) for i in range(4)]
        outs = [cache(*a) for a in args]
        for a, got in zip(args, outs):
            for x, y in zip(got, _kernels(*a)):
                assert torch.equal(x, y)


def _three_kernels(k1, k4, x, flow):
    return tsm.tsm_conv(*k1, "relu"), cs.fused_conv_stack(*k4), wp.backward_warp_fast(x, flow, s2d_out=4)


def test_launch_counters_exact_after_replays(dev):
    k1, k4 = _kernel_inputs(dev, 3)
    g = torch.Generator(device=dev).manual_seed(4)
    x = _randn(g, dev, 1, 32, 48, 3)
    flow = torch.randn((1, 32, 48, 2), generator=g, device=dev)
    cache = ShapeCache(_three_kernels)
    before = (tsm.launches, tsm.launches_by_device.get(dev.index or 0, 0), cs.launches, wp.launches)
    with torch.inference_mode():
        for _ in range(5):
            cache(k1, k4, x, flow)
    assert cache.num_graphs == 1
    after = (tsm.launches, tsm.launches_by_device.get(dev.index or 0, 0), cs.launches, wp.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (5, 5, 10, 5)


def test_a_call_across_devices_raises(dev):
    cache = ShapeCache(lambda a, b: a + b.to(a.device))
    with torch.inference_mode(), pytest.raises(ValueError, match="one CUDA device"):
        cache(torch.ones(2, device=dev), torch.ones(2))


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_denoise_service_replays_equal_the_eager_steps(dev):
    """The denoise service at K1's widths (C = 64, 128) and a K4 body,
    bf16, 12 micro-batches of 4 and the drain, through its graphs (warm: 2,
    one a ring phase), then a second stream: bit for bit the eager steps
    driven the same way, with 16 K1 launches a chunk."""
    cfg_b, cfg_s = bsvd.BSVDConfig(chns=(8, 64, 128)), srvgg.SRVGGConfig(num_feat=64, num_conv=4)
    lr, out = (32, 48), (64, 96)
    svc = EsrganUpscalerService(lr_level=0, output_shape=out, denoise_rate=0.75, batch_size=4, srvgg_cfg=cfg_s,
                                bsvd_cfg=cfg_b, conv_stack=1, device=dev)
    svc.lr_shape = lr
    svc.proc_init()
    params = svc._params
    frames = _frames(1, (48, *lr, 3))
    chunks = [frames[i : i + 4] for i in range(0, 48, 4)]

    def sr_apply(p, x):
        return srvgg.apply_down_rational(p, x, 2, 1, cfg=cfg_s, conv_stack=1)

    with torch.inference_mode():
        state = steps.init_denoise_state(1, svc.spec, cfg_b, device=dev)
        want = []
        for c in chunks:
            o, state = steps.upscale_batch_denoise(sr_apply, params, state, torch.from_numpy(c).to(dev), svc.spec,
                                                   cfg_b, warm=state["t"] >= bsvd.SHIFT_NUM, inplace=True)
            want.append(o.cpu().numpy())
        state = bsvd.ring_to_fifo_state(state, cfg_b)
        for i in range(0, bsvd.SHIFT_NUM, 4):
            o, state = steps.flush_batch_denoise(sr_apply, params, state,
                                                 torch.from_numpy(frames[32 + i : 36 + i]).to(dev), 48, svc.spec, cfg_b)
            want.append(o.cpu().numpy())
    want = np.concatenate(want)
    for _ in range(2):
        k1 = tsm.launches
        got = np.concatenate([svc.upscale(c) for c in chunks] + [np.asarray(e.frames) for e in svc.proc_eof()])
        assert tsm.launches - k1 == 16 * (12 + 4)
        np.testing.assert_array_equal(got, want)
        svc.reset_stream()
    assert svc._warm_step.num_graphs == 2


def test_egvsr_service_replays_equal_the_eager_steps(dev):
    """The EGVSR service per frame (one K3 launch a frame) through its
    step's graph, bf16, 8 frames with a scene cut: bit for bit the eager
    steps."""
    cfg = egvsr.EGVSRConfig(nf=16, nb=2)
    lr = (16, 64)
    svc = EgvsrUpscalerService(lr_level=0, output_shape=(64, 256), cfg=cfg, device=dev)
    svc.lr_shape = lr
    svc.proc_init()
    frames = _frames(2, (8, *lr, 3))
    frames[5] = 255 - frames[5]
    with torch.inference_mode():
        state = egvsr.init_recurrent_state(1, *lr, cfg, torch.bfloat16, dev)
        want = []
        for f in frames:
            o, state = steps.egvsr_upscale_step(svc._params, state, torch.from_numpy(f[None]).to(dev), svc.spec,
                                                cut_threshold=0.12, cfg=cfg)
            want.append(o.cpu().numpy())
    k3 = wp.launches
    got = np.concatenate([svc.upscale(frames[i : i + 4]) for i in (0, 4)])
    assert wp.launches - k3 == 8 and svc._step.num_graphs == 1
    np.testing.assert_array_equal(got, np.concatenate(want))


def test_fixed_weights_are_read_where_they_lie(dev):
    """A fixed argument (the weights) gets no static buffer: a replay reads
    the caller's tensors, sees a write into them in place, and refuses
    other tensors of the same signature."""
    _, (x, w, b, a) = _kernel_inputs(dev, 8)
    cache = ShapeCache(lambda p, y: cs.fused_conv_stack(y, *p), fixed_argnums=(0,))
    p = (w, b, a)
    with torch.inference_mode():
        for _ in range(3):
            assert torch.equal(cache(p, x), cs.fused_conv_stack(x, *p))
        w.mul_(0.5)
        assert cache.num_graphs == 1 and torch.equal(cache(p, x), cs.fused_conv_stack(x, *p))
        with pytest.raises(ValueError, match="same tensors"):
            cache((w.clone(), b, a), x)


def test_max_graphs_bounds_the_graphs_and_their_memory(dev, monkeypatch):
    """Past MAX_GRAPHS, a recurring signature runs eagerly: the graphs held
    and the device memory they pin stop growing, and every output still
    equals the eager call's."""
    _, k4 = _kernel_inputs(dev, 5)
    g = torch.Generator(device=dev).manual_seed(6)
    xs = [_randn(g, dev, 1, 16, 8 * k, 64) for k in range(2, 7)]
    monkeypatch.setattr(jit_cache, "MAX_GRAPHS", 2)
    cache = ShapeCache(cs.fused_conv_stack)
    mem = []
    with torch.inference_mode():
        for _ in range(3):
            for x in xs:
                assert torch.equal(cache(x, *k4[1:]), cs.fused_conv_stack(x, *k4[1:]))
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated())
    assert cache.num_graphs == 2 and cache.num_signatures == 5
    assert mem[2] == mem[1]


def test_dropping_a_cache_frees_its_graphs(dev):
    """A cache's graphs, their pool and their static buffers go with the
    cache by reference counting alone."""
    args = _kernel_inputs(dev, 7)
    gc.collect()
    gc.disable()
    try:
        with torch.inference_mode():
            _kernels(*args)  # the kernels' per-device constants, made once
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            cache = ShapeCache(_kernels)
            for _ in range(3):
                cache(*args)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        del cache
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == base < held
    finally:
        gc.enable()


def test_warm_up_then_every_chunk_of_a_stream_replays_and_close_frees(dev):
    """After warm_up, a denoise stream's cold and warm chunks all replay
    (no graph is added); close() then frees the graphs' memory."""
    cfg_b, cfg_s = bsvd.BSVDConfig(chns=(8, 64, 128)), srvgg.SRVGGConfig(num_feat=64, num_conv=4)
    svc = EsrganUpscalerService(lr_level=0, output_shape=(64, 96), denoise_rate=0.75, batch_size=4, srvgg_cfg=cfg_s,
                                bsvd_cfg=cfg_b, conv_stack=1, device=dev)
    svc.lr_shape = (32, 48)
    svc.warm_up()
    held = (svc._cold_step.num_graphs, svc._warm_step.num_graphs)
    assert held == (bsvd.SHIFT_NUM // 4, 2)
    for i in range(8):
        svc.upscale(_frames(i, (4, 32, 48, 3)))
    assert (svc._cold_step.num_graphs, svc._warm_step.num_graphs) == held
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    svc.close()
    torch.cuda.synchronize()
    assert not any(isinstance(v, ShapeCache) for v in vars(svc).values())
    assert torch.cuda.memory_allocated() < before


def test_a_capture_that_fails_raises(dev):
    def syncs(x):
        # a host read of a device value: legal eagerly, refused under capture
        return x * x.sum().item()

    cache = ShapeCache(syncs)
    x = torch.ones(8, device=dev)
    stream = torch.cuda.current_stream()
    with torch.inference_mode():
        assert torch.equal(cache(x), x * 8)
        with pytest.raises(RuntimeError):
            cache(x)
    assert torch.cuda.current_stream() == stream and cache.num_graphs == 0
    # the card goes on working (this test runs last all the same)
    assert torch.equal(x * 2, torch.full((8,), 2.0, device=dev))
