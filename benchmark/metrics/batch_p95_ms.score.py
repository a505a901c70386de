"""Host ms of the 95th-percentile scoring batch, from the hand-in of the host
batch to its scores on the host, over the untraced part of the window: the
end-to-end `score_p95_ms` statistic, read per layer in the cells where that
metric is too unsteady from run to run to hold a bound (its runs spread with
the host's speed)."""


def read(r):
    return r.latency_p95_ms("score")
