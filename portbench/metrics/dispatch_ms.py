"""dispatch_ms (program span `upscaler.upscale`), layer service
(upscale/service.py, upscale/jit_cache.py): the mean host time the
service takes to enqueue a micro-batch's step (upload, graph replay,
host copy), over the micro-batches delivered inside the window."""

SPAN = "upscaler.upscale"


def read(run):
    v = [d[SPAN] for t, d in run.logs.spans if t <= run.logs.t1_ns and SPAN in d]
    return 1e3 * sum(v) / len(v) if v else None
