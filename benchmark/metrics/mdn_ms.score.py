"""Device ms a scoring batch of the kernels launched inside the MDN head's
`log_likelihood` (`models/mdn.py`, `ops/cuda/gmm.py`: the pi head, B2)."""


def read(r):
    return r.range_ms("mdn", "score")
