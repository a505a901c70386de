"""Device ms a training step of the kernels launched inside the optimizer's
step (`pipeline/optimizers.torch_adam`)."""


def read(r):
    return r.range_ms("optimizer", "train")
