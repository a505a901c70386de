"""Host ms a scoring batch inside the port's `vitad::flow` span (the
normalizing flow's forward, `models/flow.py`): the time the host spends
launching the flow head."""

from harness import spans


def read(r):
    return spans.host_ms(r, "score", "flow")
