"""The chip's peaks and the whole step's matmul and convolution work, from
the configuration's shapes (2·M·N·K a product, nothing recomputed), for the
`mfu` metrics.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit: 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32
outside them (the configuration's float32 products run with TF32 off),
3.35 TB/s of HBM. A product's least time is its FLOP over the peak of the
precision the configuration states for it; an `mfu` is the sum of the least
times of the work done, over the time it took: the share of the chip's peak
that the step used, whatever precisions it mixes."""

from __future__ import annotations

from typing import List, Tuple

from harness import spec

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

Work = List[Tuple[float, str]]  # (FLOP, stated precision)


def _flow_convs(cfg: dict) -> List[float]:
    """FLOP of each subnet convolution of one image's flow forward."""
    c = cfg["embed_dim"]
    c1, c2 = c - c // 2, c // 2
    hidden = int(c1 * cfg["hidden_ratio"])
    hw = (cfg["img_size"] // cfg["patch_size"]) ** 2
    out = []
    for i in range(cfg["flow_steps"]):
        kk = 9 if i % 2 == 0 else 1
        out += [2.0 * hw * c1 * hidden * kk, 2.0 * hw * hidden * 2 * c2 * kk]
    return out


def flow_forward(cfg: dict) -> Work:
    return [(sum(_flow_convs(cfg)), cfg["head_dtype"])]


def flow_train(cfg: dict) -> Work:
    """Forward, and in the backward each convolution's weight gradient and
    input gradient, except the input gradient of the first step's first
    convolution (the features need none)."""
    convs = _flow_convs(cfg)
    return [(3.0 * sum(convs) - convs[0], cfg["head_dtype"])]


def mdn_forward(cfg: dict) -> Work:
    d, k = cfg["embed_dim"], cfg["num_gaussians"]
    tokens = (cfg["img_size"] // cfg["patch_size"]) ** 2
    return [(2.0 * tokens * d * k, cfg["pi_dtype"]),
            (2.0 * 2 * tokens * d * d * k, cfg["head_dtype"])]


def mdn_train(cfg: dict) -> Work:
    """Forward and the three heads' weight gradients (the features need no
    gradient)."""
    return [(2.0 * f, prec) for f, prec in mdn_forward(cfg)]


def per_image(cfg: dict, kind: str) -> Work:
    """The work one image costs in a cell of traffic kind `kind`: in
    scoring the trunk family's (`trunks/<trunk>.py`, `forward_work`) and
    the head's forward, in training the head's step on cached features."""
    head = cfg["head"]
    if kind == "score":
        trunk = spec.trunk(cfg).forward_work(cfg)
        return trunk + (flow_forward(cfg) if head == "nf" else mdn_forward(cfg))
    return flow_train(cfg) if head == "nf" else mdn_train(cfg)


def least_seconds(work: Work) -> float:
    return sum(f / PEAK_FLOPS[prec] for f, prec in work)
