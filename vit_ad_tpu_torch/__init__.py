"""vit_ad_tpu_torch: the PyTorch and CUDA port of vit-ad-tpu for one NVIDIA H100.

A second package beside the JAX reference `vit_ad_tpu`, with the same module
names. It imports torch, numpy and PIL, never jax or `vit_ad_tpu`.
The TPU's Pallas kernels become hand-written Hopper kernels under `csrc/`,
built at first use (`ops/cuda/build.py`); everything else is plain PyTorch.
"""

__version__ = "0.1.0"

from vit_ad_tpu_torch.config import (  # noqa: F401
    DtypePolicy,
    HyperParams,
    set_numerics_policy,
)
