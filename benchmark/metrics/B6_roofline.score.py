"""% of B6's least time (`kernels/B6.py`) over the device time of its
launches in a traced scoring window."""


def read(r):
    return r.roofline("B6", "score")
