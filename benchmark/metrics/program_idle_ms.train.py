"""Device-idle ms a training step that lies inside the port's
`vitad::train_step` spans (`pipeline/train.optimizer_step`): the device
waits while the trainer launches or waits. The rest lies between steps."""

from harness import spans


def read(r):
    return spans.idle_ms(r, "train", "train_step")
