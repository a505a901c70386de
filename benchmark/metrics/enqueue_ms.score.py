"""Host ms a scoring batch, from the hand-in of the host batch to the return
of the payload function and the score tail, before the scores are fetched:
the host side of the scoring entry (`serving/aot` payload fn,
`pipeline/eval`). Read over the untraced part of the window."""


def read(r):
    return r.enqueue_ms("score")
