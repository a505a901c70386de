"""The trunks' tensor parallelism over the mesh's "model" axis
(`vit_ad_tpu_torch/parallel/sharding.py`, `models/tensor_parallel.py`)
against the JAX package: the rules of `vit_ad_tpu/parallel/sharding._spec_for`
on the registry trunks at full size, the shard/unshard round trip, and the
sharded forward of tiny DeiT, Swin, NesT and EfficientFormer trunks on 1x2
and 1x4 meshes of spawned gloo ranks (tests/_torch_mesh_ranks.py, no JAX in
a rank) against the JAX single-device forward from the same weights."""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from test_torch_swin import jax_params as swin_jax_params
from test_torch_swin import jax_swin
from test_torch_vit import jax_encoder, jitter
from test_torch_vit import jax_params as vit_jax_params
from vit_ad_tpu import registry as jax_registry
from vit_ad_tpu.config import DtypePolicy as JaxDtypePolicy
from vit_ad_tpu.models.efficientformer import EfficientFormer as JaxEfficientFormer
from vit_ad_tpu.models.nest import NesT as JaxNesT
from vit_ad_tpu.parallel.sharding import _spec_for
from vit_ad_tpu_torch import registry
from vit_ad_tpu_torch.parallel.sharding import (
    MODEL_COLUMNS,
    MODEL_HEADS,
    MODEL_ROWS,
    REPLICATED,
    param_shardings,
    shard_trunk_state,
    trunk_rules,
    unshard_trunk_state,
)
from vit_ad_tpu_torch.utils.convert import (
    efficientformer_state_dict_from_jax,
    nest_state_dict_from_jax,
    recon_state_dict_from_jax,
    swin_state_dict_from_jax,
    vit_state_dict_from_jax,
)

JF32 = JaxDtypePolicy.f32()
# the sharded forward against the JAX single-device forward, relative to the
# largest |token|: f32 sums in other orders (the row-parallel partials summed
# over the ranks, then the bias and the residual), through two to five blocks
TOKEN_RTOL = 2e-5
TRUNKS = list(ranks.TP_IMG)

# ---- (i) the rules against the JAX package's, on the registry trunks --------

# A JAX leaf's spec as a code that survives the port's weight converters: 0
# replicated, 1 "model" on the last (output) axis, 2 on the one before it (the
# input axis of a kernel), 3 elsewhere (a 4-D conv kernel's size-1 axis).
_CODE_SPEC = {0: REPLICATED, 1: MODEL_ROWS, 2: MODEL_COLUMNS, 3: REPLICATED}
_CONVERT = {
    "enc_deit": lambda v: vit_state_dict_from_jax(v["params"]),
    "enc_vit": lambda v: vit_state_dict_from_jax(v["params"]),
    "enc_esvit": lambda v: swin_state_dict_from_jax(v["params"]),
    "enc_nest": lambda v: nest_state_dict_from_jax(v["params"]),
    "enc_eff_former": efficientformer_state_dict_from_jax,
    "ae_deit": recon_state_dict_from_jax,
}


def _code(spec, ndim: int) -> int:
    axes = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if "model" not in axes:
        return 0
    at = axes.index("model")
    return 1 if at == ndim - 1 else 2 if at == ndim - 2 else 3


def _jax_codes(key: str):
    """The port's parameter name → the code of the JAX leaf it comes from,
    for every tensor the converter gives: each JAX leaf filled with its
    `_spec_for` code, then converted as real weights are."""
    model = jax_registry.get_model(key, 224)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    flat = flax.traverse_util.flatten_dict(flax.serialization.to_state_dict(shapes), sep=None)
    tagged = {k: np.broadcast_to(np.float32(_code(_spec_for(k, a), len(a.shape))), a.shape)
              for k, a in flat.items()}
    state = _CONVERT[key](flax.traverse_util.unflatten_dict(tagged))
    codes = {}
    for name, t in state.items():
        if t.is_floating_point() and t.numel() and float(t.min()) == float(t.max()) \
                and float(t.max()) in (1.0, 2.0, 3.0):
            codes[name] = int(t.max())
    return codes


def _split_attention(key: str, model_size: int):
    """The attention blocks the port splits: prefix → split (departure (a)
    keeps the others whole)."""
    heads = {"enc_deit": [("blocks.", 12)], "enc_vit": [("blocks.", 12)],
             "ae_deit": [("encoder.deit.blocks.", 12)],
             "enc_esvit": [(f"layers.{i}.", h) for i, h in enumerate((3, 6, 12, 24))]}
    return {p: h % model_size == 0 for p, h in heads.get(key, [])}


@pytest.mark.parametrize("key,model_size", [
    ("enc_deit", 2), ("enc_vit", 2), ("enc_esvit", 2), ("enc_esvit", 4), ("enc_nest", 2),
    ("enc_eff_former", 2), ("ae_deit", 2)])
def test_param_shardings_match_the_jax_rules(key, model_size):
    """`param_shardings` equals `_spec_for` over the JAX trunk, name for name
    through the weight converter, except the three departures, each asserted
    by name: (a) an attention whose heads M does not divide stays whole
    (EsViT stage 0 at M = 2, stages 0-1 at M = 4); (b) EfficientFormer's 4-D
    conv MLP kernels, where JAX puts "model" on a size-1 axis, stay
    replicated; (c) `qkv` is split per head, not as a contiguous block."""
    codes = _jax_codes(key)
    with torch.device("meta"):
        port = registry.get_model(key, 224)
    specs = param_shardings(port, model_size)
    split_attention = _split_attention(key, model_size)
    departures = {"a": [], "b": [], "c": []}
    for name, spec in specs.items():
        want = _CODE_SPEC[codes.get(name, 0)]
        # True / False: an attention the port splits / keeps whole; None: no
        # attention the rules reach (NesT's, EfficientFormer's)
        split = next((v for p, v in split_attention.items() if name.startswith(p)), None)
        whole = (".attn.qkv." in name or ".attn.proj.weight" in name) and split is False
        if codes.get(name) == 3:
            assert spec == REPLICATED and name.endswith(("mlp.fc1.weight", "mlp.fc2.weight")), \
                name
            departures["b"].append(name)
        elif whole:
            assert want != REPLICATED and spec == REPLICATED, name
            departures["a"].append(name)
        elif ".attn.qkv." in name and split:
            assert want == MODEL_ROWS and spec == MODEL_HEADS, name
            departures["c"].append(name)
        else:
            assert spec == want, (name, spec, want)
    depths = dict(zip(split_attention, (2, 2, 6, 2) if key == "enc_esvit" else (12,)))
    split_blocks = sum(n for p, n in depths.items() if split_attention[p])
    whole_blocks = sum(depths.values()) - split_blocks
    assert whole_blocks == {("enc_esvit", 2): 2, ("enc_esvit", 4): 4}.get((key, model_size), 0)
    assert len(departures["a"]) == 3 * whole_blocks
    assert len(departures["c"]) == 2 * split_blocks
    # EfficientFormer-L3: 22 Meta4D blocks of two 1x1-conv MLP kernels each
    assert len(departures["b"]) == (44 if key == "enc_eff_former" else 0)
    sharded = [n for n, s in specs.items() if s != REPLICATED]
    assert sharded and len(sharded) == sum(c in (1, 2) for c in codes.values()) \
        - len(departures["a"])


# ---- (ii) shard -> unshard, byte for byte -------------------------------------

@pytest.mark.parametrize("name", TRUNKS)
@pytest.mark.parametrize("model_size", [2, 4])
def test_shard_then_unshard_is_byte_equal(name, model_size):
    trunk = ranks.tp_trunk(name)
    state = trunk.state_dict()
    rules = trunk_rules(trunk, model_size)
    assert rules
    parts = [shard_trunk_state(state, rules, model_size, m) for m in range(model_size)]
    back = unshard_trunk_state(parts, rules)
    for key in rules:
        assert back[key].dtype == state[key].dtype and back[key].shape == state[key].shape
        assert torch.equal(back[key].view(torch.int32), state[key].view(torch.int32)), key
        assert parts[0][key].numel() * model_size == state[key].numel(), key


# ---- (v) what the rules cannot take is refused --------------------------------

def test_uneven_widths_are_refused():
    """An MLP hidden width that the model axis does not divide raises, in the
    JAX package's words for an uneven axis (the tiny ViT's 128 hidden units
    over 3); the MDN head's K likewise (`components`)."""
    with pytest.raises(ValueError, match="should be divisible by 3, but it is equal to 128"):
        trunk_rules(ranks.tiny_vit(), 3)
    with pytest.raises(ValueError, match="should be divisible by 3, but it is equal to 128"):
        param_shardings(ranks.tiny_vit(), 3)


# ---- (iii), (iv) the sharded forward on spawned ranks -------------------------

def _jax_nest():
    return JaxNesT(img_size=ranks.TP_IMG["nest"], **ranks.TP_CFG["nest"], dtypes=JF32)


def _jax_effformer():
    return JaxEfficientFormer(img_size=ranks.TP_IMG["effformer"], **ranks.TP_CFG["effformer"],
                              dtypes=JF32)


def _jax_inputs():
    """name → (the port's state dict of the JAX trunk's jittered f32 weights,
    images, the JAX single-device tokens)."""
    out = {}
    rng = np.random.default_rng(3)
    for name, img in ranks.TP_IMG.items():
        x = rng.standard_normal((2, img, img, 3)).astype(np.float32)
        if name == "vit":
            model, variables = jax_encoder(2, JF32), vit_jax_params(2)
            state = vit_state_dict_from_jax(variables)
        elif name == "swin":
            model, variables = jax_swin(img, JF32), swin_jax_params(img)
            state = swin_state_dict_from_jax(variables)
        else:
            model = _jax_nest() if name == "nest" else _jax_effformer()
            # jitted: op by op, the init takes several times its compile
            variables = jitter(jax.jit(model.init)(jax.random.key(0),
                                                   jnp.zeros((1, img, img, 3))),
                               np.random.default_rng(0), 0.05)
            state = (nest_state_dict_from_jax(variables, ranks.TP_CFG["nest"]["num_heads"])
                     if name == "nest" else efficientformer_state_dict_from_jax(variables))
        tokens = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)).patch_embedding)
        out[name] = (state, x, tokens)
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    inputs = str(tmp_path_factory.mktemp("tp_inputs"))
    jax_side = _jax_inputs()
    for name, (state, x, _) in jax_side.items():
        torch.save(state, os.path.join(inputs, f"{name}.pt"))
        np.save(os.path.join(inputs, f"{name}_x.npy"), x)
    worlds = {w: ranks.Ranks(ranks.tensor_parallel_world, w,
                             str(tmp_path_factory.mktemp(f"tp_world{w}")), inputs)
              for w in (2, 4)}
    return {"jax": {n: v[2] for n, v in jax_side.items()},
            "state": {n: v[0] for n, v in jax_side.items()},
            "ranks": {w: r.results() for w, r in worlds.items()}}


@pytest.mark.parametrize("name", TRUNKS)
@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "1x4"])
def test_sharded_forward_matches_jax(name, world, sharded):
    """Every model rank's tokens equal the JAX single-device forward within
    TOKEN_RTOL of the largest |token|, and the ranks' tokens equal each other
    to the bit (the summed partials are the same bytes on every rank)."""
    want = sharded["jax"][name]
    got = [r[name]["tokens"] for r in sharded["ranks"][world]]
    assert got[0].shape == want.shape
    np.testing.assert_allclose(got[0], want, rtol=0,
                               atol=TOKEN_RTOL * float(np.abs(want).max()))
    for other in got[1:]:
        assert np.array_equal(other, got[0])


@pytest.mark.parametrize("case", sorted(ranks.TP_LEVERS))
def test_sharded_forward_under_a_model_lever_matches_jax(case, sharded):
    """The sharded Swin with the gather partition and the split route onto
    B5a's plain version (on the rank's heads with its columns of the bias
    table: 4 calls a rank, none packed), the sharded Swin and ViT with the
    block norms folded: every rank against the JAX single-device forward of
    the default route (the levers sum in other orders: the split route
    within TOKEN_RTOL, the folds within 2e-4), the ranks equal to the bit."""
    name, _ = ranks.TP_LEVERS[case]
    want = sharded["jax"][name]
    rtol = TOKEN_RTOL if case == "swin_gather_split" else 2e-4
    got = [r[name]["levers"][case] for r in sharded["ranks"][2]]
    np.testing.assert_allclose(got[0][0], want, rtol=0, atol=rtol * float(np.abs(want).max()))
    assert all(np.array_equal(tokens, got[0][0]) for tokens, _ in got[1:])
    assert [calls for _, calls in got] == [4 if case == "swin_gather_split" else 0] * 2


@pytest.mark.parametrize("name", TRUNKS)
@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "1x4"])
def test_each_rank_holds_its_shard(name, world, sharded):
    """The trunk really is sharded: a split attention's `qkv.weight` is
    [3C/M, C] and its `proj.weight` [C, C/M], every `fc1.weight` [H/M, D] and
    `fc2.weight` [D, H/M]; what is not split keeps its shape. The gathered
    state equals the full one byte for byte, and a forward that would need a
    gradient raises."""
    full = sharded["state"][name]
    split = {k: s for k, s in trunk_rules(ranks.tp_trunk(name), world).items()}
    n_qkv = 0
    for r in sharded["ranks"][world]:
        shapes = r[name]["shapes"]
        for key, shape in full.items():
            got = shapes[key]
            if split.get(key) in (MODEL_ROWS, MODEL_HEADS):
                assert got == (shape.shape[0] // world, *shape.shape[1:]), key
                n_qkv += key.endswith("attn.qkv.weight")
            elif split.get(key) == MODEL_COLUMNS:
                assert got == (shape.shape[0], shape.shape[1] // world), key
            else:
                assert got == tuple(shape.shape), key
        assert r[name]["gathered_equal"] and r[name]["grad_refused"]
    assert any(k.endswith("mlp.fc1.weight") for k in split)
    # the tiny ViT's 4 heads split on both meshes, the Swin's two heads on 1x2
    # only; NesT and EfficientFormer keep their attention whole
    split_blocks = {"vit": 2, "swin": 2 if world == 2 else 0}.get(name, 0)
    assert n_qkv == split_blocks * world
