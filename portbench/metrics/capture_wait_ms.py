"""capture_wait_ms (program counter: the entries' captured_at), layer
stream (stream/recoder.py): the mean, over delivered source frames due in
the window, of their capture batch's close (captured_at) minus the
frame's due time at the source."""


def read(run):
    w = run.acct.capture_wait_ms
    return sum(w) / len(w) if w else None
