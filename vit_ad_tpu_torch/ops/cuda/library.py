"""The kernels' registered ops, in one import.

Importing this module registers every op of `ops/gates.GATES`
(`vit_ad_tpu_torch::vit_attention_qkv`, `::swin_window_attention`,
`::split_window_attention`, `::mlp_block`, `::mlp_gemm`, `::layer_norm`,
`::gmm_forward`, `::flow_coupling`) with `torch.library`, each with its
fake implementation. A serving site imports it before `torch.export.load`
reads a native bundle (`serving/aot.load_bundle` does). It pulls in torch and
the wrappers only (no models, no pipeline) and builds nothing: the kernel
library is compiled from `csrc/` at the first launch.
"""

from vit_ad_tpu_torch.ops.cuda import flow, gmm, layer_norm, mlp, window_attention  # noqa: F401
