"""Device-idle ms a scoring batch that lies inside the port's own spans
(the union of every `vitad::` range: the payload function, its layers and
the score tail, `vit_ad_tpu_torch/utils/profiling.span`): the device waits
while the program launches or waits. The rest of the idle time lies in the
client's copy of the images in and its fetch of the scores."""

from harness import spans


def read(r):
    return spans.idle_ms(r, "score")
