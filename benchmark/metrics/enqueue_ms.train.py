"""Host ms a training step, from the hand-in of the staged batch to the
return of `pipeline/train.train_step`, with no synchronise: the trainer's
host side. Read over the untraced part of the window."""


def read(r):
    return r.enqueue_ms("train")
