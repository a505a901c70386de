"""B7, the one-pass LayerNorm kernel (`vit_ad_tpu_torch/csrc/layer_norm.cu`,
`layer_norm_common.cuh`): f32 statistics over the last dim of bf16 rows
[M, D], the f32 affine, bf16 out. In the DeiT/ViT trunk every launch is a
[B·T, D] norm: the blocks' first norms and the final norm through B7, and
B6's LayerNorm step, the same kernel.

Work of a launch: ~8·M·D FLOP; bytes: the rows read once and written once,
the f32 scale and shift read once."""

PATTERN = r"layer_norm(_rows)?_kernel"
COUNTERS = {"B7": "vit_ad_tpu_torch.ops.cuda.layer_norm.launches"}
BF16, F32 = 2, 4


def flop_bytes(rows: int, dim: int):
    return 8.0 * rows * dim, float(2 * rows * dim * BF16 + 2 * dim * F32)


def shapes(cfg: dict, batch: int):
    tokens = (cfg["img_size"] // cfg["patch_size"]) ** 2 + cfg["num_prefix_tokens"]
    return batch * tokens, cfg["embed_dim"]


def least_seconds(launches: int, shape) -> float:
    from harness.flops import PEAK_BYTES, PEAK_FLOPS

    flop, nbytes = flop_bytes(*shapes(shape.cfg, shape.batch))
    return launches * max(flop / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES)
