"""% of B3's least time (`kernels/B3.py`) over the device time of its
launches in a traced training window."""


def read(r):
    return r.roofline("B3", "train")
