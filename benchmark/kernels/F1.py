"""F1, the flow's coupling tail (`vit_ad_tpu_torch/csrc/flow_coupling.cu`):
one launch a flow step. It reads the step's input halves x1 [B, c1, H, W] and
x2 [B, c2, H, W] and the subnet's raw output a [B, 2·c2, H, W], all f32, and
writes the output's halves (C = c1 + c2 channels, each at its permuted place)
and the logdet [B]. The NF head on a [H, W, C] map: `flow_steps` launches a
batch (20 on DeiT-base's [14, 14, 768]).

Work of a launch: ~20 FLOP a coupled element (0.1 scale, soft clamp, exp,
affine, global affine, logdet) and 2 a passed-through one (global affine);
bytes: x1, x2 and a read once, the output written once, the per-channel global
scale and offset (f32) and perm (int64) read once, the logdet written once."""

PATTERN = r"flow_coupling_kernel"
COUNTERS = {"F1": "vit_ad_tpu_torch.ops.cuda.flow.launches"}
F32, I64 = 4, 8
FLOP_COUPLED, FLOP_PASSED = 20, 2


def flop_bytes(batch: int, channels: int, hw: int):
    c2 = channels // 2
    c1 = channels - c2
    flop = batch * hw * (FLOP_COUPLED * c2 + FLOP_PASSED * c1)
    nbytes = batch * hw * F32 * (c1 + c2 + 2 * c2 + channels) \
        + channels * (2 * F32 + I64) + batch * F32
    return float(flop), float(nbytes)


def shapes(cfg: dict, batch: int):
    return batch, cfg["embed_dim"], (cfg["img_size"] // cfg["patch_size"]) ** 2


def least_seconds(launches: int, shape) -> float:
    from harness.flops import PEAK_BYTES, PEAK_FLOPS

    flop, nbytes = flop_bytes(*shapes(shape.cfg, shape.batch))
    return launches * max(flop / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES)
