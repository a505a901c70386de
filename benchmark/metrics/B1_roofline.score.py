"""% of B1's least time (`kernels/B1.py`) over the device time of its
launches in a traced scoring window."""


def read(r):
    return r.roofline("B1", "score")
