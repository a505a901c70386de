"""% of B2's least time (`kernels/B2.py`) over the device time of its
launches in a traced scoring window."""


def read(r):
    return r.roofline("B2", "score")
