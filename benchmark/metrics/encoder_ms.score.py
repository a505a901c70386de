"""Device ms a scoring batch of the kernels launched inside the encoder's
range (`models/vit.py`: preprocess cast, patch convolution, 12 blocks, final
norm)."""


def read(r):
    return r.range_ms("encoder", "score")
