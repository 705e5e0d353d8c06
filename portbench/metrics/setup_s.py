"""setup_s: process start to the first timed call: imports, the CUDA
context, kernel libraries (built on a checkout's first run), weights,
calibration and quantisation, the warm-up of the mix's buckets."""


def read(r):
    return r.setup_s
