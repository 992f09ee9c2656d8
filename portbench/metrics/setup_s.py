"""setup_s (host clock): from the process's start to the window's
opening: imports, the CUDA context, the weights, the kernels' build on a
checkout's first run, warm_up()'s graph captures, the pipeline's start."""


def read(run):
    return run.logs.setup_s
