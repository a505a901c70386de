"""The port's spans (`vit_ad_tpu_torch/utils/profiling.span`) on the CPU at
small size: off without a profiler; under one, the names and nesting of a
scoring batch of each head and of a training step, with the batch or step
number on the outer span; one `operands` span a make of the compute-dtype
weights; and a serving export that is the same inside a profiler as outside
it, with no profiler op in its graph."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vit_ad_tpu_torch.config import DtypePolicy, HyperParams
from vit_ad_tpu_torch.models.efficientformer import EfficientFormer
from vit_ad_tpu_torch.models.efficientnet import EfficientNetEncoder
from vit_ad_tpu_torch.models.flow import NormalizingFlow
from vit_ad_tpu_torch.models.mdn import GaussianMDN
from vit_ad_tpu_torch.models.nest import NesT
from vit_ad_tpu_torch.models.resnet import ResNet50
from vit_ad_tpu_torch.models.swin import SwinTransformer
from vit_ad_tpu_torch.models.vit import ViTEncoder
from vit_ad_tpu_torch.pipeline import train as T
from vit_ad_tpu_torch.pipeline.loading import RunModels
from vit_ad_tpu_torch.pipeline.optimizers import torch_adam
from vit_ad_tpu_torch.scoring import scores_tail
from vit_ad_tpu_torch.serving import aot
from vit_ad_tpu_torch.utils import profiling

IMG, PATCH, D, DEPTH, HEADS, K = 32, 8, 32, 3, 4, 2
F32 = DtypePolicy.f32()
UNITS = ["nf", "mdn", "train"]


def _models(kind):
    g = torch.Generator().manual_seed(11)
    deit = ViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                      num_heads=HEADS, num_prefix_tokens=2, dtypes=F32, generator=g).eval()
    if kind == "nf":
        head = NormalizingFlow(D, IMG, (IMG // PATCH) ** 2, hidden_ratio=0.5, flow_steps=2,
                               generator=g)
    else:
        head = GaussianMDN(D, K, dtypes=F32, generator=g)
    hp = HyperParams(model_name="enc_deit", architecture=kind, img_size=IMG, dtypes=F32)
    return RunModels(kind, hp, (deit, head.eval()))


def _unit(kind):
    """A function that runs one unit of `kind`: a scoring batch through the
    serving path's payload function and score tail, or one MDN train step."""
    g = torch.Generator().manual_seed(12)
    if kind == "train":
        mdn = GaussianMDN(D, K, dtypes=F32, generator=g).train()
        opt = torch_adam(mdn.parameters(), 1e-3)
        feats = torch.randn(2, (IMG // PATCH) ** 2, D, generator=g)
        valid = torch.ones(2)
        return lambda: T.train_step(T.masked_mdn_loss, mdn, opt, feats, valid,
                                    torch.Generator().manual_seed(0))
    fn, _ = aot.build_payload_fn_and_params(_models(kind))
    tail = scores_tail(kind, IMG, [0.0] if kind == "mdn" else None)
    images = torch.randint(0, 256, (2, IMG, IMG, 3), dtype=torch.uint8, generator=g)

    def batch():
        with torch.inference_mode():
            return tail(fn(images))

    return batch


def _spans(prof):
    """[(name without the prefix, start, end, args)] of the trace's spans,
    in order of start."""
    out = [(e.name()[len(profiling.PREFIX):], e.start_ns(), e.end_ns(), e.kwinputs())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(profiling.PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parent(spans, i):
    """The name of the innermost span that encloses span i (None at the
    top): the last one before it, in order of start, that ends after it."""
    _, a, b, _ = spans[i]
    enclosing = [s[0] for s in spans[:i] if s[1] <= a and b <= s[2]]
    return enclosing[-1] if enclosing else None


def _units(spans, outer):
    """The spans of each unit: from one `outer` span (and the spans at the
    top level after it, the score tail) to the next."""
    starts = [i for i, s in enumerate(spans) if s[0] == outer]
    return [spans[i:j] for i, j in zip(starts, starts[1:] + [len(spans)])]


@pytest.mark.parametrize("kind", ["span"] + UNITS)
def test_spans_are_off_without_a_profiler(kind, monkeypatch):
    """No profiler: `span` is the shared no-op, and a unit opens no range."""
    opened = []
    monkeypatch.setattr(profiling, "_Range", lambda *a: opened.append(a))
    if kind == "span":
        assert profiling.span("encoder") is profiling._OFF
        assert profiling.span("payload", {"batch": 3}) is profiling._OFF
    else:
        run = _unit(kind)
        run()
        run()
    assert opened == []


# each unit's spans: (name, its parent) → count, and its outer span
WANT = {
    "nf": ("payload", {("payload", None): 1, ("preprocess", "payload"): 1,
                       ("encoder", "payload"): 1, ("block", "encoder"): DEPTH,
                       ("flow", "payload"): 1, ("tail", None): 1}),
    "mdn": ("payload", {("payload", None): 1, ("preprocess", "payload"): 1,
                        ("encoder", "payload"): 1, ("block", "encoder"): DEPTH,
                        ("mdn", "payload"): 1, ("tail", None): 1}),
    # the MDN's kernel operands are read on the card only: no `operands` here
    "train": ("train_step", {("train_step", None): 1, ("zero_grad", "train_step"): 1,
                             ("loss", "train_step"): 1, ("mdn", "loss"): 1,
                             ("backward", "train_step"): 1,
                             ("optimizer", "train_step"): 1}),
}


@pytest.mark.parametrize("kind", UNITS)
def test_spans_name_and_nest_each_layer(kind):
    """Three units under a profiler: each opens the spans of its layers,
    each inside the one above it; the outer span carries the unit's number,
    one more each unit; the first scoring batch makes the trunk's weights
    (one `operands` span in the encoder), the later ones make none."""
    run = _unit(kind)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for _ in range(3):
            run()
    spans = _spans(prof)
    outer, want = WANT[kind]
    units = _units(spans, outer)
    assert len(units) == 3
    numbers = []
    for u, unit in enumerate(units):
        count = {}
        for i, s in enumerate(spans):
            if s in unit:
                key = (s[0], _parent(spans, i))
                count[key] = count.get(key, 0) + 1
        made = count.pop(("operands", "encoder"), 0)
        assert made == (1 if u == 0 and kind != "train" else 0), (u, count)
        assert count == want, u
        (args,) = [s[3] for s in unit if s[0] == outer]
        (key,) = args
        assert key == ("step" if kind == "train" else "batch")
        numbers.append(args[key])
        assert all(not s[3] for s in unit if s[0] != outer)
    assert numbers == list(range(numbers[0], numbers[0] + 3))


# tiny f32 trunks, as the port's model tests build them: (image side, builder)
TRUNKS = {
    "vit": (IMG, lambda g: ViTEncoder(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                                      num_heads=HEADS, dtypes=F32, generator=g)),
    "swin": (56, lambda g: SwinTransformer(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2),
                                           num_heads=(1, 2), window=7, dtypes=F32, generator=g)),
    "nest": (32, lambda g: NesT(img_size=32, embed_dims=(32, 64, 64), num_heads=(1, 2, 2),
                                depths=(1, 1, 1), dtypes=F32, generator=g)),
    "efficientformer": (32, lambda g: EfficientFormer(img_size=32, dims=(8, 16), depths=(2, 3),
                                                      vit_num=2, num_heads=2, key_dim=4,
                                                      attn_ratio=2, dtypes=F32, generator=g)),
    "efficientnet": (32, lambda g: EfficientNetEncoder(img_size=32, dtypes=F32, generator=g,
                                                       blocks=((1, 8, 1, 1, 3), (6, 16, 2, 2, 3)))),
    "resnet": (32, lambda g: ResNet50(F32)),  # torch's init: the JAX one is slow at this width
}


@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_each_trunk_opens_one_encoder_span(trunk):
    """Every trunk's forward is one `encoder` span a call (the ViT's with a
    `block` span a block inside), its weights made once inside it."""
    img, build = TRUNKS[trunk]
    model = build(torch.Generator().manual_seed(6)).eval()
    x = torch.rand(1, img, img, 3, generator=torch.Generator().manual_seed(7))
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.inference_mode():
        model(x)
        model(x)
    spans = _spans(prof)
    count = {}
    for i, s in enumerate(spans):
        key = (s[0], _parent(spans, i))
        count[key] = count.get(key, 0) + 1
    want = {("encoder", None): 2, ("operands", "encoder"): 1}
    if trunk == "vit":
        want[("block", "encoder")] = 2 * DEPTH
    assert count == want


@pytest.mark.parametrize("training", [False, True])
def test_operands_span_counts_each_make(training):
    """`ComputeWeights.get` opens `operands` once a make: once for a frozen
    head (then the cache), every call while gradients flow."""
    mdn = GaussianMDN(D, K, dtypes=DtypePolicy(),
                      generator=torch.Generator().manual_seed(3)).train(training)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.set_grad_enabled(training):
            for _ in range(3):
                mdn.kernel_operands()
    names = [s[0] for s in _spans(prof)]
    assert names == ["operands"] * (3 if training else 1)


@pytest.mark.parametrize("kind", ["nf", "mdn"])
def test_export_inside_a_profiler_is_unchanged(kind, tmp_path):
    """A portable scores bundle exported inside a running profiler holds no
    kernel op and no profiler op, and its graph is the one exported outside
    any profiler."""
    m = _models(kind)
    ref = np.random.default_rng(4).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    graphs = []
    for inside in (False, True):
        out = tmp_path / str(inside)
        with profile(activities=[ProfilerActivity.CPU]) if inside else contextlib.nullcontext():
            aot.export_bundle(m, str(out), batch=2, payload="scores", ref_images=ref)
        ep = torch.export.load(str(out / aot.SCORER_NAME))
        assert aot._ops_in(ep) == []
        assert not [n for n in ep.graph.nodes if "profiler" in str(n.target)]
        graphs.append(ep.graph_module.code)
    assert graphs[0] == graphs[1]
