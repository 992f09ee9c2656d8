"""The plain reference of the benchmark's configurations: PyTorch float32
forward passes written from the published networks (models.py), the
restream paths' stream semantics over them (stream.py) and the control's
lower precision (quant.py).  It imports nothing of the program and takes
nothing the program made: it reads the weights files and regenerates the
source frames from the seed."""
