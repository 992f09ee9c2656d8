"""queue_wait_ms (program span `recoder.output`), layer pipeline
(pipeline.py): the mean wait of a micro-batch between its cut from the
capture batch and the service's pick-up, over the micro-batches
delivered inside the window."""

SPAN = "recoder.output"


def read(run):
    v = [d[SPAN] for t, d in run.logs.spans if t <= run.logs.t1_ns and SPAN in d]
    return 1e3 * sum(v) / len(v) if v else None
