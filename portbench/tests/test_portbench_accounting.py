"""frames_per_s, latency_p95_ms, attempted and failed from synthetic
stamp records, with a drop and a stall; the lookahead's mapping."""

import numpy as np
import pytest

from portbench.accounting import DRAIN, account, build_outputs, nearest_rank
from portbench.registry import load_metric

MS = 1_000_000
T0 = 10_000 * MS


def _source(n, fps):
    due = np.array([T0 + round(i * 1e9 / fps) for i in range(n)], np.int64)
    return np.stack([due, due + MS], axis=1)


def test_nearest_rank():
    assert nearest_rank(list(range(1, 101)), 95) == 95
    assert nearest_rank([5.0], 95) == 5.0
    assert nearest_rank([3, 1, 2], 50) == 2


def test_egvsr_mapping_with_a_dropped_micro_batch_and_a_stall():
    fps, batch = 8, 4
    source = _source(16, fps)                       # 2 s of a paced source
    captures = [(8, (T0 + 1000 * MS) / 1e9), (8, (T0 + 2000 * MS) / 1e9)]
    service = [(0, 4), (1, 4), (3, 4)]              # micro-batch 2 (frames 8-11) shed
    delivered = list(service)
    # frames 0-3 arrive at 1.2 s, 4-7 at 1.3 s, 12-15 stall until 5 s
    arrivals = [T0 + 1200 * MS] * 4 + [T0 + 1300 * MS] * 4 + [T0 + 5000 * MS] * 4
    a = account("egvsr", batch, T0, T0 + 2000 * MS, source, captures, service, delivered, arrivals,
                t_end_ns=T0 + 6000 * MS)
    assert a.attempted == 16 and a.failed == 4
    assert a.delivered_in_window == 8
    # the four dropped frames count from their due time to the run's end, above every delivered one
    assert list(a.latencies_ms[8:12]) == [6000 - 1000 * i / fps for i in (8, 9, 10, 11)]
    delivered_lat = [x for i, x in enumerate(a.latencies_ms) if not 8 <= i < 12]
    assert min(a.latencies_ms[8:12]) > max(delivered_lat)

    class Run:
        pass

    run = Run()
    run.acct = a
    assert load_metric("frames_per_s").read(run) == pytest.approx(8 / 2.0)
    assert load_metric("latency_p95_ms").read(run) == nearest_rank(a.latencies_ms, 95)
    assert a.capture_wait_ms[0] == pytest.approx(1000.0)


def test_realesrgan_lookahead_and_drain():
    batch = 4
    captures = [(24, 1.0)]                          # 6 micro-batches
    service = [(k, 4) for k in range(6)] + [(DRAIN, 16)]
    outputs, tl = build_outputs("realesrgan", captures, service, batch)
    assert len(outputs) == 24 + 16 and len(tl.frames) == 24
    assert [o.carries for o in outputs[:16]] == [None] * 16
    assert [o.carries for o in outputs[16:24]] == list(range(8))
    assert [o.den for o in outputs[16:24]] == list(range(8))
    assert [o.carries for o in outputs[24:]] == list(range(8, 24))
    assert all(o.den == o.position for o in outputs[24:])


def test_realesrgan_padded_tail_is_left_out_of_the_drain():
    captures = [(6, 1.0)]                           # micro-batches of 4 and 2; the 2 padded to 4
    service = [(0, 4), (1, 2), (DRAIN, 6)]
    outputs, tl = build_outputs("realesrgan", captures, service, 4)
    assert tl.frames == [0, 1, 2, 3, 4, 5, 5, 5] and tl.real == [True] * 6 + [False] * 2
    assert [o.carries for o in outputs[6:]] == [0, 1, 2, 3, 4, 5]


def test_frames_the_service_does_not_account_for_are_counted():
    source = _source(4, 4)
    a = account("egvsr", 4, T0, T0 + 10**9, source, [(4, 1.0)], [(0, 4)], [(0, 4)], [T0] * 3, T0 + 2 * 10**9)
    assert a.mismatched == 1                        # the sink read 3 of the 4 frames sent
    a = account("realesrgan", 4, T0, T0 + 10**9, source, [(4, 1.0)], [(0, 4), (DRAIN, 4)], [(0, 4), (DRAIN, 2)],
                [T0] * 6, T0 + 2 * 10**9)
    assert a.mismatched == 2 and a.sink_outputs[-1].carries == 1   # a drain of 2 where 4 were due


def test_step_mfu_reads_the_traced_frames_over_the_device_busy_time(monkeypatch):
    from types import SimpleNamespace

    from portbench.trace import Trace

    mfu = load_metric("step_mfu_pct")
    monkeypatch.setattr(mfu, "frame_flops", lambda config: 1e12)
    trace = Trace([("k", T0, T0 + 400 * MS), ("k", T0 + 300 * MS, T0 + 800 * MS), ("k", T0 + 1500 * MS, T0 + 1600 * MS)],
                  (T0, T0 + 1000 * MS))
    fetched = [(T0 - 10 * MS, 4), (T0 + 500 * MS, 4), (T0 + 900 * MS, 3), (T0 + 1200 * MS, 4)]
    run = SimpleNamespace(trace=trace, logs=SimpleNamespace(fetched=fetched), config={})
    # 7 frames done inside the traced second, the card busy 0.8 s of it (a union, not 0.9 s of sums)
    assert mfu.read(run) == pytest.approx(100 * 1e12 * 7 / 0.8 / 989e12)
    assert mfu.read(SimpleNamespace(trace=None, logs=run.logs, config={})) is None
    assert mfu.read(SimpleNamespace(trace=trace, logs=SimpleNamespace(fetched=fetched[:1]), config={})) is None
