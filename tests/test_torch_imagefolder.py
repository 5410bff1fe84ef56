"""The port's streaming ImageFolder loader against the JAX package's.

A folder of a few dozen small JPEGs (varied sizes, one grayscale, one CMYK
that the native decoder refuses and PIL decodes, one PNG), in ``train``
and ``val``, through ``ImageNet(data_dir)`` with ``native_decode`` off
(PIL) and on (libjpeg):

* the decoded uint8 images equal the JAX package's, train and eval;
* the normalized batches equal the JAX package's numpy tail bit for bit,
  and its native tail within what C10 lets it move;
* the train geometry is seeded: equal for a seed, other for another seed
  or epoch, and the same at any number of decode threads;
* ``n_samples`` with and without ``random_sample``, ``validation_split``
  and ``shard`` through the prefetched loader, as in JAX;
* the cases of ``tests/test_imagefolder.py``, rerun on the port;
* the flagship's YAML reading the folder through the FSPTQ entry.
"""

from pathlib import Path

import numpy as np
import pytest

from dlmc_quant_tpu.data import loaders as J
from dlmc_quant_tpu.data import native as jnative
from dlmc_quant_torch.data import native
from dlmc_quant_torch.data.loaders import (IMAGENET_MEAN, IMAGENET_STD,
                                           DataLoader, ImageFolderDataset,
                                           ImageNet, PrefetchLoader,
                                           get_dataloader, scan_image_folder)
from test_torch_data_loaders import near_jax_native

REPO = Path(__file__).resolve().parent.parent
Image = pytest.importorskip("PIL.Image")
CLASSES, PER_CLASS, SIZE = ("n01", "n02", "n03"), 8, 32
DECODE = [False, True]
DECODE_IDS = ["pil", "native"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """3 classes × 8 images in each split, 40–90 px a side, smooth
    patterns under noise; in ``train/n01`` one grayscale JPEG, one CMYK
    JPEG and one PNG."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for cls in CLASSES:
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(PER_CLASS):
                h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
                base = rng.integers(0, 255, (4, 4, 3)).astype(np.float64)
                ys = np.arange(h) * 4 // h
                xs = np.arange(w) * 4 // w
                arr = np.clip(base[ys][:, xs] + rng.normal(0, 30, (h, w, 3)),
                              0, 255).astype(np.uint8)
                im = Image.fromarray(arr)
                if split == "train" and cls == "n01" and i < 3:
                    kind = ("L", "CMYK", "PNG")[i]
                    if kind == "PNG":
                        im.save(d / f"img_{i}.png")
                        continue
                    im = im.convert(kind)
                im.save(d / f"img_{i}.jpg", quality=90)
    return root


def _pair(folder, native_decode, workers=2, **kw):
    """(the port's loader, JAX's) on the same arguments, unprefetched."""
    args = dict(data_dir=str(folder), batch_size=4, size=SIZE,
                synthetic_fallback=False, prefetch_depth=0,
                native_decode=native_decode, num_workers=workers, **kw)
    return ImageNet(**args), J.ImageNet(**args)


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


def test_decoders_are_built():
    assert native.jpeg_available(), native.JPEG.error
    assert jnative.jpeg_available()


def test_scan_matches_jax(folder):
    for split in ("train", "val"):
        got = scan_image_folder(folder / split)
        want = J.scan_image_folder(folder / split)
        assert got[0] == want[0] and got[2] == want[2] == list(CLASSES)
        np.testing.assert_array_equal(got[1], want[1])
        assert len(got[0]) == len(CLASSES) * PER_CLASS


def _jax_decoded(jds, idx, rng):
    """The JAX dataset's uint8 images of a batch, by its own transforms
    (its ``get_batch`` returns them normalized)."""
    if not (jds.train_augment and rng is not None):
        return np.stack([jds._decode_eval(jds.paths[i]) for i in idx])
    out = []
    for i, r in zip(idx, rng.spawn(len(idx))):
        p = jds.paths[i]
        data = dims = None
        if jds.native_decode:
            data = p.read_bytes()
            dims = jnative.jpeg_dims(data)
        if dims is None:
            with Image.open(p) as im:
                dims, data = im.size, None
        box = jds._rrc_params(*dims, r)
        flip = bool(r.random() < 0.5)
        out.append(jds._decode_train(p, *box, flip, data=data))
    return np.stack(out)


@pytest.mark.parametrize("native_decode", DECODE, ids=DECODE_IDS)
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_decoded_images_equal_jax(folder, training, native_decode):
    port, ref = _pair(folder, native_decode, training=training)
    pds, jds = port.dataset, ref.dataset
    assert pds.native_decode == jds.native_decode == native_decode
    idx = np.arange(len(pds))
    got = pds.decode(idx, np.random.default_rng(11) if training else None)
    want = _jax_decoded(jds, idx,
                        np.random.default_rng(11) if training else None)
    assert got.dtype == np.uint8 and got.shape == (len(idx), SIZE, SIZE, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native_decode", DECODE, ids=DECODE_IDS)
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batches_equal_jax(folder, training, native_decode, monkeypatch):
    """Two epochs of batches: the JAX package's numpy tail bit for bit,
    its native tail (``(x - mean)·(1/std)``, C10) as near as it can be."""
    port, ref = _pair(folder, native_decode, training=training, seed=2)
    assert len(port) == len(ref) == len(CLASSES) * PER_CLASS // 4
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = list(port)
        with_native = list(ref)
        with monkeypatch.context() as m:
            m.setattr(jnative, "available", lambda: False)
            numpy_tail = list(ref)
        for (x, y), (xn, yn), (xr, yr) in zip(got, with_native, numpy_tail):
            assert x.dtype == np.float32 and x.shape == (4, SIZE, SIZE, 3)
            np.testing.assert_array_equal(_bits(x), _bits(xr))
            near_jax_native(x, xn, IMAGENET_STD, True)
            np.testing.assert_array_equal(y, yr)
            np.testing.assert_array_equal(y, yn)


@pytest.mark.parametrize("native_decode", DECODE, ids=DECODE_IDS)
def test_train_geometry_independent_of_workers(folder, native_decode):
    """Each image's box and flip come from its own child stream: one
    decode thread or several give the same batches."""
    batches = []
    for workers in (1, 3, 8):
        port, _ = _pair(folder, native_decode, workers=workers, seed=4)
        port.set_epoch(3)
        batches.append([x for x, _ in port])
    for other in batches[1:]:
        for a, b in zip(batches[0], other):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_native_and_pil_fall_back_per_image(folder):
    """The CMYK JPEG and the PNG: the native loader decodes them with PIL,
    as the PIL loader does (and the JAX package)."""
    paths, labels, _ = scan_image_folder(folder / "train")
    odd = [i for i, p in enumerate(paths)
           if p.suffix == ".png" or Image.open(p).mode == "CMYK"]
    assert len(odd) == 2
    nat = ImageFolderDataset(paths, labels, SIZE, native_decode=True)
    pil = ImageFolderDataset(paths, labels, SIZE, native_decode=False)
    np.testing.assert_array_equal(nat.decode(np.array(odd), None),
                                  pil.decode(np.array(odd), None))


@pytest.mark.parametrize("random_sample", [True, False],
                         ids=["random", "first"])
def test_n_samples_match_jax(folder, random_sample):
    port, ref = _pair(folder, True, n_samples=10,
                      random_sample=random_sample, seed=6, training=False)
    assert port.n_samples == ref.n_samples == 10
    assert port.dataset.paths == list(ref.dataset.paths)
    for (x, y), (xr, yr) in zip(port, ref):
        near_jax_native(x, xr, IMAGENET_STD, True)
        np.testing.assert_array_equal(y, yr)


def test_validation_split_and_shard_through_prefetch(folder):
    """The factory's prefetched loader proxies ``set_epoch``, ``len``,
    ``split_validation`` and ``shard``, with the JAX package's indices."""
    kw = dict(data_dir=str(folder), batch_size=4, size=SIZE, seed=1,
              validation_split=0.25, synthetic_fallback=False)
    port, ref = ImageNet(**kw), J.ImageNet(**kw)
    assert isinstance(port, PrefetchLoader) and port.depth == 2
    assert len(port) == len(ref) == 4
    val, rval = port.split_validation(), ref.split_validation()
    np.testing.assert_array_equal(val.indices, rval.indices)
    np.testing.assert_array_equal(port.indices, ref.indices)
    port.set_epoch(1)
    ref.set_epoch(1)
    for (x, y), (xr, yr) in zip(port, ref):
        near_jax_native(x, xr, IMAGENET_STD, True)
        np.testing.assert_array_equal(y, yr)
    for rank in (0, 1):
        s, r = port.shard(rank, 2), ref.shard(rank, 2)
        np.testing.assert_array_equal(s.indices, r.indices)
        (x, _), (xr, _) = next(iter(s)), next(iter(r))
        near_jax_native(x, xr, IMAGENET_STD, True)


# -- tests/test_imagefolder.py, on the port ----------------------------------

def test_scan_image_folder(folder):
    paths, labels, classes = scan_image_folder(folder / "train")
    assert classes == list(CLASSES)
    assert len(paths) == 24 and set(labels) == {0, 1, 2}


@pytest.mark.parametrize("native_decode", DECODE, ids=DECODE_IDS)
def test_streaming_no_materialization(folder, native_decode):
    loader = ImageNet(str(folder), batch_size=4, training=True, size=SIZE,
                      synthetic_fallback=False, prefetch_depth=0,
                      native_decode=native_decode)
    ds = loader.dataset
    assert isinstance(ds, ImageFolderDataset)
    assert not hasattr(ds, "images")          # O(batch): paths only
    batches = list(loader)
    assert len(batches) == 6                   # 24 images / 4, drop_last
    for x, y in batches:
        assert x.shape == (4, SIZE, SIZE, 3) and x.dtype == np.float32
        assert y.shape == (4,)
        assert np.isfinite(x).all()


@pytest.mark.parametrize("native_decode", DECODE, ids=DECODE_IDS)
def test_train_transform_randomized_but_seeded(folder, native_decode):
    def batches(seed, epoch=1):
        loader = ImageNet(str(folder), batch_size=4, training=True,
                          size=SIZE, synthetic_fallback=False, seed=seed,
                          prefetch_depth=0, native_decode=native_decode)
        loader.set_epoch(epoch)
        return [x for x, _ in loader]

    a, b, c = batches(0), batches(0), batches(1)
    for xa, xb in zip(a, b):                   # same seed → identical
        np.testing.assert_array_equal(xa, xb)
    assert any(not np.array_equal(xa, xc) for xa, xc in zip(a, c))
    e2 = batches(0, epoch=2)                   # another epoch → other crops
    assert any(not np.array_equal(x1, x2) for x1, x2 in zip(a, e2))


def test_eval_transform_matches_reference_semantics(folder):
    """Eval = Resize(size/0.875) + CenterCrop(size), exactly a hand-rolled
    PIL computation."""
    loader = ImageNet(str(folder), batch_size=4, training=False, size=SIZE,
                      native_decode=False, synthetic_fallback=False,
                      shuffle=False, prefetch_depth=0)
    paths, labels, _ = scan_image_folder(folder / "val")
    x, y = next(iter(loader))
    im = Image.open(paths[0]).convert("RGB")
    w, h = im.size
    scale = int(SIZE / 0.875) / min(w, h)
    im = im.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
    w, h = im.size
    left, top = (w - SIZE) // 2, (h - SIZE) // 2
    ref = np.asarray(im.crop((left, top, left + SIZE, top + SIZE)),
                     np.uint8).astype(np.float32) / 255.0
    ref = (ref - IMAGENET_MEAN) / IMAGENET_STD
    np.testing.assert_array_equal(x[0], ref)
    assert y[0] == labels[0]


def test_native_eval_close_to_pil(folder):
    """The fused crop + resize of the native eval transform stays near
    PIL's two resizes (another filter, not the same bytes)."""
    paths, labels, _ = scan_image_folder(folder / "val")
    idx = np.arange(len(paths))
    nat = ImageFolderDataset(paths, labels, SIZE, native_decode=True)
    pil = ImageFolderDataset(paths, labels, SIZE, native_decode=False)
    gap = np.abs(nat.decode(idx, None).astype(int)
                 - pil.decode(idx, None).astype(int))
    assert gap.mean() < 12, gap.mean()


def test_prefetch_wraps_streaming(folder):
    loader = ImageNet(str(folder), batch_size=4, training=True, size=SIZE,
                      synthetic_fallback=False)   # default prefetch
    assert isinstance(loader, PrefetchLoader)
    xs = [x for x, _ in loader]
    assert len(xs) == 6 and xs[0].shape == (4, SIZE, SIZE, 3)


def test_shard_and_subsample(folder):
    loader = ImageNet(str(folder), batch_size=2, training=True, size=SIZE,
                      synthetic_fallback=False, n_samples=8,
                      prefetch_depth=0)
    assert loader.n_samples == 8
    s0 = loader.shard(0, 2)
    s1 = loader.shard(1, 2)
    assert s0.n_samples + s1.n_samples == 8
    assert isinstance(s0, DataLoader)
    x, _ = next(iter(s0))
    assert x.shape == (2, SIZE, SIZE, 3)


def test_missing_folder(tmp_path):
    with pytest.raises(FileNotFoundError):
        ImageNet(str(tmp_path), synthetic_fallback=False)
    loader = ImageNet(str(tmp_path), n_samples=8, size=16, batch_size=4)
    assert not isinstance(loader, PrefetchLoader)
    assert next(iter(loader))[0].shape == (4, 16, 16, 3)


def test_flagship_yaml_reads_the_folder(folder, tmp_path):
    """The flagship's own YAML (``FSPTQ_repvgg_a0_w8a8.yaml``: RepVGG-A0,
    ImageNet loaders, ``random_sample``) pointed at the folder and cut to
    32², 16 calibration and 8 eval images at batch 8, 2 iterations a
    block: the FSPTQ entry runs on the CPU through its checkpoint and its
    chained int8 evaluation, reading the folder."""
    from dlmc_quant_torch.examples import FSPTQuant
    from dlmc_quant_torch.utils.checkpoint import load_checkpoint
    from dlmc_quant_torch.utils.config import read_yaml, write_yaml
    cfg = read_yaml(REPO / "examples" / "configs"
                    / "FSPTQ_repvgg_a0_w8a8.yaml")
    cfg["save_dir"] = str(tmp_path / "saved")
    cfg["train_sample_num"] = 16
    for name, n in (("train", 16), ("eval", 8)):
        cfg["dataloaders"][name]["args"].update(
            data_dir=str(folder), size=SIZE, n_samples=n, batch_size=8,
            num_workers=2)
    cfg["trainer"].update(epochs=2, recon_batch=8)
    train = get_dataloader("ImageNet", **cfg["dataloaders"]["train"]["args"])
    assert isinstance(train, PrefetchLoader) and train.n_samples == 16
    assert all(str(p).startswith(str(folder / "train"))
               for p in train.dataset.paths)
    path = tmp_path / "cfg.yaml"
    write_yaml(cfg, path)
    assert FSPTQuant.main(["-c", str(path), "--device", "cpu"]) == 0
    (ckpt,) = (tmp_path / "saved" / "models").glob("*/*/fsptq_model")
    _, meta = load_checkpoint(ckpt)
    assert len(meta["block_losses"]) == 23   # the stem, 21 blocks, the head
