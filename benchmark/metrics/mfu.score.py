"""% of the chip's peak used by scoring: the least time of the matmul and
convolution work of the images scored in the traced window
(`harness/flops.py`), over the window."""


def read(r):
    return r.mfu("score")
