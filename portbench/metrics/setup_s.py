"""setup_s: from the start of run.py to the first timed frame: imports,
the kernel library (built by nvcc on a checkout's first run only),
weights and frames from the seed, the program, two warm-up forwards."""


def read(run):
    return run.setup_s
