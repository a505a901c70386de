"""Device ms a scoring batch of the kernels launched inside the flow head's
range (`models/flow.py`: 20 steps, the anomaly map and its upsampling)."""


def read(r):
    return r.range_ms("flow", "score")
