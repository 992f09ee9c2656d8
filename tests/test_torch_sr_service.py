"""The port's SR-only path on the CPU in float32 against the JAX
package's: request coalescing in EsrganUpscalerService (denoising off,
the image server's settings) and upscale/tile.py::tile_upscale.

Tolerances: uint8 outputs may differ by 1 (a float32 value that differs
in its last bits falls on the other side of the truncating cast); float
outputs at atol 1e-4 (sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu.runtime import EOF as JEOF
from sharkshark_tpu.upscale.service import EsrganUpscalerService as JService
from sharkshark_tpu.upscale.service import UpscalerQueueEntry as JEntry
from sharkshark_tpu.upscale.tile import tile_upscale as jtile_upscale
from sharkshark_tpu_torch.models import srvgg
from sharkshark_tpu_torch.runtime import EOF
from sharkshark_tpu_torch.upscale import tile_upscale
from sharkshark_tpu_torch.upscale.service import EsrganUpscalerService, UpscalerQueueEntry

TINY_J = jsrvgg.SRVGGConfig(num_feat=16, num_conv=2)
TINY = srvgg.SRVGGConfig(num_feat=16, num_conv=2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A tiny SRVGG checkpoint in the reference key layout, which both
    services load through their own from_torch."""
    tp = srvgg.init_params(torch.Generator().manual_seed(4), TINY)
    rng = np.random.default_rng(4)
    sd = {}
    for i, (conv, act) in enumerate(zip(tp["convs"], tp["acts"])):
        sd[f"body.{2 * i}.weight"] = conv["w"].permute(3, 2, 0, 1).contiguous()
        sd[f"body.{2 * i}.bias"] = torch.from_numpy((rng.standard_normal(16) * 0.01).astype(np.float32))
        sd[f"body.{2 * i + 1}.weight"] = act["alpha"]
    n = len(tp["convs"])
    sd[f"body.{2 * n}.weight"] = tp["tail"]["w"].permute(3, 2, 0, 1).contiguous()
    sd[f"body.{2 * n}.bias"] = tp["tail"]["b"]
    path = tmp_path_factory.mktemp("w") / "srvgg-tiny.pth"
    torch.save({"params": sd}, path)
    return str(path)


def _image_server_kw(weights, **kw):
    """The image server's service settings: SR only, one frame a request,
    no LR/HR resize, outputs at the model's own 4x size."""
    return dict(lr_level=0, denoising=False, batch_size=1, lr_hr_resize=False,
                output_shape=None, weights=weights, **kw)


def _drive_queued(svc, entry_cls, eof_cls, jobs):
    """Queue every job and the EOF before the worker starts, so the
    service sees them all at once, as concurrent requests arrive."""
    dispatched = []
    orig = svc.upscale_dispatch

    def counting(frames):
        dispatched.append(len(frames))
        return orig(frames)

    svc.upscale_dispatch = counting
    out = []
    svc.on_queue = out.append
    for i, frames in enumerate(jobs):
        svc.push_job(entry_cls(frames=frames, step=i), timeout=60)
    svc.push_eof()
    svc.start()
    assert svc.wait_eof(timeout=300)
    svc.join(timeout=60)
    assert not svc.is_alive and svc._error is None, svc._error
    assert isinstance(out[-1], eof_cls)
    return out[:-1], dispatched


def test_coalescing_keeps_order_and_per_request_outputs(weights):
    rng = np.random.default_rng(5)
    # 3 requests of one shape, one of another (stashed, not merged), then 2
    shapes = [(1, 16, 24, 3)] * 3 + [(1, 12, 20, 3)] + [(1, 16, 24, 3)] * 2
    jobs = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    tsvc = EsrganUpscalerService(compute_dtype=torch.float32, srvgg_cfg=TINY, device="cpu",
                                 **_image_server_kw(weights, coalesce_max=8))
    got, dispatched = _drive_queued(tsvc, UpscalerQueueEntry, EOF, jobs)
    assert dispatched == [3, 1, 2]
    assert [e.step for e in got] == list(range(len(jobs)))
    jsvc = JService(compute_dtype=jnp.float32, srvgg_cfg=TINY_J, **_image_server_kw(weights, coalesce_max=8))
    want, _ = _drive_queued(jsvc, JEntry, JEOF, jobs)
    alone = EsrganUpscalerService(compute_dtype=torch.float32, srvgg_cfg=TINY, device="cpu",
                                  **_image_server_kw(weights))
    alone.proc_init()
    for job, g, w in zip(jobs, got, want):
        g = np.asarray(g.frames)
        assert g.shape == (1, job.shape[1] * 4, job.shape[2] * 4, 3) and g.dtype == np.uint8
        for other in (np.asarray(w.frames), alone.upscale(job)):
            assert np.abs(g.astype(np.int16) - other.astype(np.int16)).max() <= 1


def test_coalescing_is_off_when_denoising(weights):
    svc = EsrganUpscalerService(device="cpu", denoising=True, coalesce_max=8)
    assert svc.coalesce_max == 1
    svc = EsrganUpscalerService(device="cpu", denoising=False, coalesce_max=8)
    assert svc.coalesce_max == 8


@pytest.mark.parametrize("h,w,tile,pad", [
    (40, 56, 16, 4),   # reflect padding, 3 x 4 tiles
    (17, 40, 16, 4),   # the bottom pad reaches past the image: edge padding
    (12, 14, 16, 4),   # one tile: the whole image at once
])
def test_tile_upscale_matches_jax(h, w, tile, pad):
    tp = srvgg.init_params(torch.Generator().manual_seed(6), TINY)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    x = np.random.default_rng(7).random((2, h, w, 3)).astype(np.float32)
    got = tile_upscale(lambda p, im: srvgg.apply(p, im, cfg=TINY), tp, torch.from_numpy(x),
                       tile=tile, tile_pad=pad)
    want = jtile_upscale(lambda p, im: jsrvgg.apply(p, im, cfg=TINY_J), jp, jnp.asarray(x),
                         tile=tile, tile_pad=pad)
    assert got.shape == (2, 4 * h, 4 * w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
