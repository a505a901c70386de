"""B2, the GMM forward (`vit_ad_tpu_torch/csrc/gmm.cu`, bf16:
`gmm_forward_wgmma_kernel`): the sigma and mu heads' products [R, D] x
[D, D·K] for R = B·P tokens, the densities and the online logsumexp over K,
ll [R, D] f32 out. One launch a forward call.

Work of a launch: 2·R·D·D·K FLOP for each of the two heads; bytes: x (f32)
and the log mixture weights read once, both bf16 weight matrices and the f32
biases read once, ll written once."""

PATTERN = r"gmm_forward(_wgmma)?_kernel"
COUNTERS = {"B2": "vit_ad_tpu_torch.ops.cuda.gmm.fwd_launches"}
BF16, F32 = 2, 4


def flop_bytes(rows: int, dim: int, k: int):
    flop = 2.0 * 2 * rows * dim * dim * k
    nbytes = (rows * dim + rows * k) * F32 + 2 * dim * dim * k * BF16 + 2 * dim * k * F32 \
        + rows * dim * F32
    return flop, float(nbytes)


def shapes(cfg: dict, batch: int):
    return (batch * (cfg["img_size"] // cfg["patch_size"]) ** 2, cfg["embed_dim"],
            cfg["num_gaussians"])


def least_seconds(launches: int, shape) -> float:
    from harness.flops import PEAK_BYTES, PEAK_FLOPS

    flop, nbytes = flop_bytes(*shapes(shape.cfg, shape.batch))
    return launches * max(flop / PEAK_FLOPS[shape.cfg["head_dtype"]], nbytes / PEAK_BYTES)
