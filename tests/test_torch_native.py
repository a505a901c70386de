"""The port's native image decoder (`vit_ad_tpu_torch/data/native.py`)
against the JAX package's (`vit_ad_tpu/data/native.py`): both build the one
source `native/dataio.cpp`, so images, masks and batches agree bit for bit,
and so do the two `DataPipeline`s with the native decoder on in both. Plus
the PIL fall-back: `VITAD_NO_NATIVE=1`, a library that does not build (one
logged line naming the reason), and a truncated file raising a member of
`DECODE_ERRORS` whichever decoder runs."""

import logging
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from vit_ad_tpu.data import native as jax_native
from vit_ad_tpu.data.loader import DataPipeline as JaxPipeline
from vit_ad_tpu.data.synthetic import make_mvtec_category
from vit_ad_tpu_torch.cli.score import list_images
from vit_ad_tpu_torch.data import dataset, native
from vit_ad_tpu_torch.data.loader import DataPipeline


def _fresh(mp: pytest.MonkeyPatch, no_native: bool) -> None:
    """Both native modules re-check availability under the given setting;
    their remembered first answers are saved and restored with it, so later
    tests in the same worker see the process's own."""
    if no_native:
        mp.setenv("VITAD_NO_NATIVE", "1")
    else:
        mp.delenv("VITAD_NO_NATIVE", raising=False)
    for mod in (jax_native, native):
        mp.setattr(mod, "_tried", False)
        mp.setattr(mod, "_lib", None)
    mp.setattr(native, "reason", "")


@pytest.fixture
def native_on(monkeypatch):
    _fresh(monkeypatch, no_native=False)
    assert native.decoder() == "native", native.reason
    assert jax_native.get_lib() is not None


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """PNG (RGB, RGBA, grayscale) and JPEG images of odd sizes, and a mask."""
    root = tmp_path_factory.mktemp("torch_native")
    rng = np.random.default_rng(7)
    paths = {}
    for name, mode, shape in (("rgb.png", "RGB", (37, 53, 3)), ("rgba.png", "RGBA", (41, 29, 4)),
                              ("gray.png", "L", (33, 33)), ("photo.jpeg", "RGB", (45, 60, 3)),
                              ("photo.jpg", "RGB", (24, 24, 3))):
        p = str(root / name)
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(p)
        paths[name] = p
    mask = np.zeros((37, 53), np.uint8)
    mask[5:20, 9:40] = 255
    paths["mask"] = str(root / "mask.png")
    Image.fromarray(mask).save(paths["mask"])
    truncated = str(root / "truncated.png")
    with open(paths["rgb.png"], "rb") as f:
        data = f.read()
    with open(truncated, "wb") as f:
        f.write(data[: len(data) // 2])
    paths["truncated"] = truncated
    return paths


@pytest.mark.parametrize("name", ["rgb.png", "rgba.png", "gray.png", "photo.jpeg", "photo.jpg"])
@pytest.mark.parametrize("size", [32, 61])
def test_load_image_equals_jax_bit_for_bit(native_on, files, name, size):
    got = native.load_image(files[name], size)
    want = jax_native.load_image(files[name], size)
    assert got is not None and want is not None
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the data layer decodes through it
    np.testing.assert_array_equal(dataset.load_image(files[name], size), got)


def test_load_mask_and_batch_equal_jax(native_on, files):
    got, want = native.load_mask(files["mask"], 24), jax_native.load_mask(files["mask"], 24)
    assert got is not None and set(np.unique(got)) <= {0, 1} and got.any()
    np.testing.assert_array_equal(got, want)
    batch = [files[n] for n in ("rgb.png", "rgba.png", "gray.png", "photo.jpeg")]
    got = native.load_batch(batch, 40, n_threads=3)
    np.testing.assert_array_equal(got, jax_native.load_batch(batch, 40, n_threads=3))
    np.testing.assert_array_equal(got, np.stack([native.load_image(p, 40) for p in batch]))
    # one bad file fails the whole batch, as in the JAX binding
    assert native.load_batch(batch + [files["truncated"]], 40) is None


def test_pipeline_batches_equal_jax_with_native_decode(native_on, tmp_path):
    cat = make_mvtec_category(str(tmp_path), "widget", img_size=45, n_train=1,
                              n_test_good=3, n_test_defect=4)
    fs = list_images(os.path.join(cat, "test"))
    # masks through the data layer too: the labelled layout
    mine = list(DataPipeline(batch_size=3, img_size=32, base_path=cat, data_path="test",
                             validation_mode=True).test_batches(0))
    theirs = list(JaxPipeline(batch_size=3, img_size=32, base_path=cat, data_path="test",
                              validation_mode=True).test_batches(prefetch=0, host=True))
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        for field in ("images", "valid", "masks", "labels"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert any(b.masks.any() for b in mine)
    files_mine = np.concatenate([b.images for b in DataPipeline(4, 32, files=fs).test_batches(0)])
    files_theirs = np.concatenate([b.images for b in JaxPipeline(
        batch_size=4, img_size=32, files=fs).test_batches(prefetch=0, host=True)])
    np.testing.assert_array_equal(files_mine, files_theirs)


@pytest.mark.parametrize("no_native", [True, False], ids=["pil", "native"])
def test_truncated_file_raises_a_decode_error(monkeypatch, files, no_native):
    _fresh(monkeypatch, no_native)
    assert native.decoder() == ("pil" if no_native else "native")
    if no_native:
        assert native.reason == "VITAD_NO_NATIVE=1"
    with pytest.raises(dataset.DECODE_ERRORS):
        dataset.load_image(files["truncated"], 32)
    # a whole file decodes either way
    assert dataset.load_image(files["rgb.png"], 32).shape == (32, 32, 3)


def test_a_library_that_does_not_build_falls_back_with_one_logged_line(monkeypatch, tmp_path,
                                                                       caplog, files):
    _fresh(monkeypatch, no_native=False)
    broken = tmp_path / "dataio.cpp"
    broken.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "SO", tmp_path / "_build" / "libvitad_dataio.so")
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.decoder() == "pil"
        assert native.decoder() == "pil"
        img = dataset.load_image(files["rgb.png"], 32)
    assert [r.levelno for r in caplog.records] == [logging.WARNING]
    assert "g++ failed" in native.reason and native.reason in caplog.records[0].getMessage()
    assert not (tmp_path / "_build" / "libvitad_dataio.so").exists()
    with Image.open(files["rgb.png"]) as im:
        want = np.asarray(im.convert("RGB").resize((32, 32), Image.BILINEAR))
    np.testing.assert_array_equal(img, want)


def test_builds_the_one_source_into_its_own_directory(monkeypatch, tmp_path, files):
    """A fresh build of `native/dataio.cpp` (the JAX package's source) into
    a new directory: the library is there, no temporary file is left, and it
    decodes as the JAX package's."""
    _fresh(monkeypatch, no_native=False)
    src = tmp_path / "dataio.cpp"
    shutil.copy(jax_native._SRC, src)
    so = tmp_path / "_build" / "libvitad_dataio.so"
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "SO", so)
    assert native.decoder() == "native", native.reason
    assert os.listdir(so.parent) == [so.name]
    np.testing.assert_array_equal(native.load_image(files["photo.jpeg"], 32),
                                  jax_native.load_image(files["photo.jpeg"], 32))
