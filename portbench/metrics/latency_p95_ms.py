"""latency_p95_ms (host clock): the 95th percentile, by nearest rank, of
every source frame due in the window, from its due time at the source
to the arrival at the sink of the output that carries it; a frame that
never arrived counts above every delivered one (accounting.py)."""

from portbench.accounting import nearest_rank


def read(run):
    return nearest_rank(run.acct.latencies_ms, 95)
