"""Optimizers with the reference's torch semantics (port of
`vit_ad_tpu/pipeline/optimizers.py`)."""

from __future__ import annotations

from typing import Iterable

import torch


def torch_adam(params: Iterable[torch.nn.Parameter], learning_rate: float,
               weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam with coupled L2 weight decay (added to the gradient before the
    moments), as the reference's heads use it (reference
    src/pipeline/LearnerMDN.py:130); the JAX package rebuilt it in optax."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
