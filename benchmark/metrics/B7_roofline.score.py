"""% of B7's least time (`kernels/B7.py`) over the device time of its
launches in a traced scoring window."""


def read(r):
    return r.roofline("B7", "score")
