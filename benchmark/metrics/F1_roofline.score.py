"""% of F1's least time (`kernels/F1.py`) over the device time of its
launches in a traced scoring window (20 a DeiT NF-20 batch)."""


def read(r):
    return r.roofline("F1", "score")
