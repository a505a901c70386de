"""B3, the GMM backward to the heads' parameters (`vit_ad_tpu_torch/csrc/gmm.cu`,
bf16: `gmm_terms_wgmma_kernel` and `gmm_wgrad_wgmma_kernel`, a pair a chunk
of components): the terms recompute the forward's two products on each
chunk to form dmu and dpre, and the weight gradients are dmuᵀ x and dpreᵀ x.
The chunks of one step cover all K components once.

Work of a step (R = B·P tokens): the recomputed products 2·2·R·D·D·K FLOP
and the weight gradients as many (PERF.md's bound of B3 counts both);
bytes: x and the log mixture weights and the incoming gradient read once,
the bf16 weights read once, the f32 weight gradients written once."""

PATTERN = r"gmm_(terms|wgrad)(_wgmma)?_kernel"
# B4, the backward to the features, has no count of its own; its launches
# are counted here beside B3's
COUNTERS = {"B3": "vit_ad_tpu_torch.ops.cuda.gmm.bwd_params_launches",
            "B4": "vit_ad_tpu_torch.ops.cuda.gmm.bwd_x_launches"}
BF16, F32 = 2, 4


def flop_bytes(rows: int, dim: int, k: int):
    flop = 2.0 * 2 * 2 * rows * dim * dim * k
    nbytes = (2 * rows * dim + rows * k) * F32 + 2 * dim * dim * k * BF16 \
        + 2 * dim * dim * k * F32
    return flop, float(nbytes)


def shapes(cfg: dict, batch: int):
    return (batch * (cfg["img_size"] // cfg["patch_size"]) ** 2, cfg["embed_dim"],
            cfg["num_gaussians"])


def least_seconds(launches: int, shape) -> float:
    """The steps' work (`shape.units` steps), whatever the chunking."""
    from harness.flops import PEAK_BYTES, PEAK_FLOPS

    flop, nbytes = flop_bytes(*shapes(shape.cfg, shape.batch))
    return shape.units * max(flop / PEAK_FLOPS[shape.cfg["head_dtype"]], nbytes / PEAK_BYTES)
