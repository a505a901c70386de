"""% of the chip's peak used by training: the least time of the forward
and the gradients of the rows stepped in the traced window
(`harness/flops.py`), over the window."""


def read(r):
    return r.mfu("train")
