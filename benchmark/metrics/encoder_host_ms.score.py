"""Host ms a scoring batch inside the port's `vitad::encoder` span (the
trunk's forward, `models/vit.py`): the time the host spends launching the
trunk, which the device does not see."""

from harness import spans


def read(r):
    return spans.host_ms(r, "score", "encoder")
