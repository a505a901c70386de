"""Port data layer (`vit_ad_tpu_torch/data/`) against the JAX package:
`preprocess`, `AnomalyDataset` decode under VITAD_NO_NATIVE=1 (PIL on both
sides; the native decoder on both sides is tests/test_torch_native.py), and
the padded file-list batches of `DataPipeline`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ad_tpu.cli.score import list_images as jax_list_images
from vit_ad_tpu.data import native
from vit_ad_tpu_torch.data import native as port_native
from vit_ad_tpu.data.dataset import AnomalyDataset as JaxDataset
from vit_ad_tpu.data.dataset import default_norm_stats as jax_norm_stats
from vit_ad_tpu.data.loader import DataPipeline as JaxPipeline
from vit_ad_tpu.data.loader import preprocess as jax_preprocess
from vit_ad_tpu.data.synthetic import make_mvtec_category
from vit_ad_tpu_torch.cli.score import list_images
from vit_ad_tpu_torch.data.dataset import AnomalyDataset, default_norm_stats
from vit_ad_tpu_torch.data.loader import DataPipeline, preprocess


@pytest.fixture(scope="module")
def category(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    return make_mvtec_category(str(root), "widget", img_size=40, n_train=2,
                               n_test_good=3, n_test_defect=4)


def pil_decode(mp: pytest.MonkeyPatch) -> None:
    """VITAD_NO_NATIVE=1 for both data layers (PIL decode on both sides).
    Each native module remembers its first availability check for the whole
    process, so that memory is saved and restored with the variable: later
    tests in the same worker still find the native decoder."""
    mp.setenv("VITAD_NO_NATIVE", "1")
    for mod in (native, port_native):
        mp.setattr(mod, "_tried", False)
        mp.setattr(mod, "_lib", None)


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    pil_decode(monkeypatch)


def test_preprocess_matches_jax():
    imgs = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    mean, std = default_norm_stats()
    jm, js = jax_norm_stats()
    assert np.array_equal(mean, jm) and np.array_equal(std, js)
    want = np.asarray(jax_preprocess(jnp.asarray(imgs), jnp.asarray(jm), jnp.asarray(js)))
    got = preprocess(torch.from_numpy(imgs), torch.from_numpy(mean), torch.from_numpy(std))
    # f32 divide and standardize; XLA may fuse into multiply-by-reciprocal
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    plain = preprocess(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(plain, np.asarray(jax_preprocess(jnp.asarray(imgs))),
                               rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="std"):
        preprocess(torch.from_numpy(imgs), torch.from_numpy(mean))


def test_list_images_matches_jax(category):
    files = list_images(category)
    assert files == jax_list_images(category) and len(files) == 2 + 3 + 4 + 4  # + masks


@pytest.mark.parametrize("img_size", [32, 56])
def test_dataset_decodes_like_jax(category, img_size):
    files = list_images(f"{category}/test")
    ours = AnomalyDataset(files, img_size, validation=True)
    theirs = JaxDataset(files, img_size, validation=True)
    for i in range(len(files)):
        (img, mask, label), (jimg, jmask, jlabel) = ours[i], theirs[i]
        assert img.dtype == np.uint8 and img.shape == (img_size, img_size, 3)
        assert np.array_equal(img, jimg) and np.array_equal(mask, jmask)
        assert label == jlabel
    assert sum(ours[i][2] for i in range(len(files))) == 4  # the defects
    assert any(ours[i][1].any() for i in range(len(files)))  # masks were read


@pytest.mark.parametrize("batch_size", [3, 4, 16])
def test_padded_batches_match_jax(category, batch_size):
    files = list_images(f"{category}/test")  # 7 images: padded tails
    ours = list(DataPipeline(batch_size, 32, files=files).test_batches())
    theirs = list(JaxPipeline(batch_size=batch_size, img_size=32, files=files)
                  .test_batches(host=True))
    assert len(ours) == len(theirs) == -(-len(files) // batch_size)
    for a, b in zip(ours, theirs):
        assert a.images.shape == (batch_size, 32, 32, 3)
        for field in ("images", "valid", "masks", "labels"):
            assert np.array_equal(getattr(a, field), np.asarray(getattr(b, field))), field
    assert sum(int(a.valid.sum()) for a in ours) == len(files)


def test_pipeline_needs_files_and_surfaces_decode_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        DataPipeline(2, 32, files=[])
    bad = tmp_path / "broken.png"
    bad.write_bytes(b"not an image")
    with pytest.raises(Exception, match="cannot identify|broken"):
        list(DataPipeline(2, 32, files=[str(bad)]).test_batches())
