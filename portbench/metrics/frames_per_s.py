"""frames_per_s (host clock): the source frames whose output reached the
sink inside the window, over the window's seconds."""


def read(run):
    return run.acct.delivered_in_window / run.acct.seconds
