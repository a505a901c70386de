"""B6's two products (`vit_ad_tpu_torch/csrc/mlp_block.cu`, the bf16 route's
`wgmma` GEMMs): fc1 with the tanh GELU in its epilogue, [M, D] x [D, H]
→ bf16 [M, H], then fc2 with the residual in its epilogue, [M, H] x [H, D]
+ [M, D] → bf16 [M, D], M = B·T rows. Two launches a block, in that
order. The route's third kernel, its LayerNorm step, is B7's rows kernel
and is counted there.

Work of a pair: 2·M·D·H FLOP each; bytes: the operands read once, the
residual read once, the outputs written once (bf16; the f32 biases)."""

PATTERN = r"gemm_bf16_kernel"
COUNTERS = {"B6": "vit_ad_tpu_torch.ops.cuda.mlp.launches",
            "B6_wgmma": "vit_ad_tpu_torch.ops.cuda.mlp.wgmma_launches"}
BF16, F32 = 2, 4


def flop_bytes(rows: int, dim: int, hidden: int):
    """((FLOP, bytes) of fc1, (FLOP, bytes) of fc2)."""
    flop = 2.0 * rows * dim * hidden
    fc1 = (rows * dim + dim * hidden + rows * hidden) * BF16 + hidden * F32
    fc2 = (rows * hidden + hidden * dim + 2 * rows * dim) * BF16 + dim * F32
    return (flop, float(fc1)), (flop, float(fc2))


def shapes(cfg: dict, batch: int):
    tokens = (cfg["img_size"] // cfg["patch_size"]) ** 2 + cfg["num_prefix_tokens"]
    return batch * tokens, cfg["embed_dim"], int(cfg["embed_dim"] * cfg["mlp_ratio"])


def least_seconds(launches: int, shape) -> float:
    from harness.flops import PEAK_BYTES, PEAK_FLOPS

    pair = sum(max(f / PEAK_FLOPS["bfloat16"], b / PEAK_BYTES)
               for f, b in flop_bytes(*shapes(shape.cfg, shape.batch)))
    return launches / 2 * pair
