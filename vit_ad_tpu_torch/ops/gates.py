"""The single registry of the port's kernels, by the TPU kernel each one
ports (counterpart of `vit_ad_tpu/ops/pallas/gates.py`).

Every C entry point of the kernel library (`ops/cuda/build.ENTRY_POINTS`)
that a wrapper in `ops/cuda/` launches belongs to one kernel here, with the
ops of `torch.library` it is registered under (`vit_ad_tpu_torch::<op>`). The
forward kernels are ops so that `torch.export` can carry them into a serving
bundle (`serving/aot.py`); B3 and B4 run only in a backward, which a bundle
never holds, so they have no op. `tests/test_torch_serving.py` greps
`ops/cuda/` and fails on a launched entry point missing here, and on an op
without a fake implementation.

Unlike the JAX registry, this one switches nothing: a CUDA tensor always
reaches its kernel, and no environment variable turns a kernel off. A
portable bundle holds no op because it is traced from a copy of the models
on the CPU, where every wrapper takes its plain version.

No imports beyond the standard library: a serving site loads this module.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

NAMESPACE = "vit_ad_tpu_torch"


class Gate(NamedTuple):
    entries: Tuple[str, ...]  # C entry points of the kernel library
    ops: Tuple[str, ...]      # registered ops (NAMESPACE::op) that launch them


GATES: Dict[str, Gate] = {
    # ops/cuda/window_attention: vit_attention_qkv, swin_attention_windows,
    # split_window_attention (the window kernel's two entries share one C entry)
    "B1": Gate(("vit_attention_qkv_forward",), ("vit_attention_qkv",)),
    "B5": Gate(("swin_window_attention_forward",), ("swin_window_attention",)),
    "B5a": Gate(("swin_window_attention_forward",), ("split_window_attention",)),
    # ops/cuda/mlp: mlp_block, and gemm_step (one product alone, card checks)
    "B6": Gate(("mlp_block_forward", "mlp_gemm_forward"), ("mlp_block", "mlp_gemm")),
    "B7": Gate(("layer_norm_forward",), ("layer_norm",)),  # ops/cuda/layer_norm
    # ops/cuda/gmm: the forward, and the backward of gmm_log_likelihood
    "B2": Gate(("gmm_forward",), ("gmm_forward",)),
    "B3": Gate(("gmm_backward_terms", "gmm_backward_weights"), ()),
    "B4": Gate(("gmm_backward_x",), ()),
}
