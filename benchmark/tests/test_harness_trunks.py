"""The trunk families (`trunks/<trunk>.py`): the configuration's `trunk` key
finds its file, the DeiT family's seeded weights are those the harness made
before the family had a file of its own, a configuration without a family
or with one that has no file stops the run, and a configuration's
`block_index` reaches the port (the DeiT family, whose reference takes the
last block, refuses any other)."""

from __future__ import annotations

import hashlib

import pytest
import torch
from conftest import ROOT, run_tiny, tiny_cell

from harness import spec, weights

# sha256 over each entry of the trunk state dict in its order (key, shape and
# dtype as text, then the float32 bytes), seed 0 on the CPU, on the generator
# that `weights.make_states` seeds (`sub_seed(0, "trunk")`). Made with
# `harness/weights.deit_state` as it stood before the DeiT family moved into
# `trunks/deit.py`; both configurations share the trunk, so the digest too.
DEIT_BASE_SEED0 = "950d2fc8ee77c2a9145e95451c34bb67c7cfeaf72e3f15bfdd683726d517855b"


def _digest(sd) -> str:
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(f"{k}:{tuple(v.shape)}:{v.dtype};".encode())
        h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["deit_nf.score_b128", "deit_mdn.score_b128"])
def test_deit_state_is_unchanged_bit_for_bit(name):
    cfg = spec.load_cell(name, ROOT).config
    assert cfg["trunk"] == "deit"
    gen = torch.Generator(device="cpu").manual_seed(weights.sub_seed(0, "trunk"))
    sd = spec.trunk(cfg).state(cfg, gen, "cpu")
    assert len(sd) == 155 and _digest(sd) == DEIT_BASE_SEED0


@pytest.mark.parametrize("trunk,message", [(None, "names no trunk family"),
                                           ("cait", r"no file benchmark/trunks/cait\.py"),
                                           ("../harness/spec", "names trunk")])
def test_a_configuration_without_its_trunk_file_stops_the_run(trunk, message):
    cell = tiny_cell("deit_nf.score_b128")
    if trunk is None:
        del cell.config["trunk"]
    else:
        cell.config["trunk"] = trunk
    with pytest.raises(SystemExit, match=message):
        spec.trunk_file(cell.config)
    with pytest.raises(SystemExit, match=message):
        run_tiny(cell)


@pytest.mark.parametrize("block_index", [None, 5])
def test_block_index_reaches_the_ports_encoder(block_index, monkeypatch):
    """`port.hyper_params` passes a configuration's `block_index` to
    `HyperParams` (absent: its default, 0, the last block), and the port's
    encoder at that index runs blocks 0..i of DeiT-base's 12."""
    from harness import port
    from vit_ad_tpu_torch.models import vit
    from vit_ad_tpu_torch.registry import get_model

    cfg = tiny_cell("deit_nf.score_b128").config
    if block_index is not None:
        cfg["block_index"] = block_index
    hp = port.hyper_params(cfg)
    assert hp.block_index == (block_index or 0)
    apply, blocks = vit._block_apply, []

    def counted(*args, **kwargs):
        blocks.append(1)
        return apply(*args, **kwargs)

    monkeypatch.setattr(vit, "_block_apply", counted)
    encoder = get_model(hp.model_name, hp.img_size, hp.dtypes, generator=None)
    with torch.no_grad():
        encoder(torch.zeros(1, 32, 32, 3), block_index=hp.block_index)
    assert len(blocks) == (block_index + 1 if block_index else 12)


def test_the_deit_family_refuses_a_feature_block():
    """The DeiT reference takes the last block's features; a configuration
    that asks for another stops at the width check, before any run."""
    from harness import port
    from vit_ad_tpu_torch.registry import get_model

    cfg = {**tiny_cell("deit_nf.score_b128").config, "block_index": 5}
    hp = port.hyper_params(cfg)
    with torch.device("meta"):
        encoder = get_model(hp.model_name, hp.img_size, hp.dtypes, generator=None)
    with pytest.raises(ValueError, match="block_index 5"):
        spec.trunk(cfg).check_widths(encoder, cfg)
