"""B1, the DeiT/ViT attention kernel (`vit_ad_tpu_torch/csrc/vit_attention_qkv.cu`):
softmax(q kᵀ / sqrt(hd)) v over each head, read from the packed bf16 qkv
[B, T, 3D] of one block, written as bf16 [B, T, D]. One launch a block.

Work of a launch: 2·T²·hd FLOP for q kᵀ and as many for p·v, per image and
head; bytes: the qkv read once and the output written once."""

PATTERN = r"(?<!window_)attention_(one_pass|bf16|f32)_kernel"
COUNTERS = {"B1": "vit_ad_tpu_torch.ops.cuda.window_attention.launches"}
BF16 = 2


def flop_bytes(batch: int, tokens: int, dim: int, heads: int):
    hd = dim // heads
    flop = 4.0 * batch * heads * tokens * tokens * hd
    return flop, float(batch * tokens * 4 * dim * BF16)


def shapes(cfg: dict, batch: int):
    tokens = (cfg["img_size"] // cfg["patch_size"]) ** 2 + cfg["num_prefix_tokens"]
    return batch, tokens, cfg["embed_dim"], cfg["num_heads"]


def least_seconds(launches: int, shape) -> float:
    from harness.flops import PEAK_BYTES, PEAK_FLOPS

    flop, nbytes = flop_bytes(*shapes(shape.cfg, shape.batch))
    return launches * max(flop / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES)
