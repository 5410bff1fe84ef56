"""The port's native data kernels (``dlmc_quant_torch/data/native``).

* The batch assembly (``augment.cpp``) gives the numpy path's bits, where
  the JAX package's pass is held to ``tests/test_native_data.py``'s 1e-5;
  against that pass, as close as ROADMAP hazard C10 lets it be.  The cases
  of ``tests/test_native_data.py`` rerun on the port.
* The JPEG decoder (``jpegdec.cpp``): ``jpeg_dims`` and
  ``jpeg_decode_resize`` return what the JAX package's return on valid
  buffers (crops, flips, every DCT scale, grayscale), truncated ones and
  garbage: equal arrays, or None on both sides.  Its source keeps nothing
  with a destructor across ``setjmp``/``longjmp`` (hazard C5).
* The build: by g++ from the sources beside the binding, into ``_build/``,
  named by a hash of the source and the command, written under a
  temporary name and renamed, so that two processes building at once
  both load a whole library; ``DLMCQ_NO_NATIVE=1`` turns both off and the
  loaders take their numpy / PIL paths.
"""

import io
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from dlmc_quant_tpu.data import native as jnative
from dlmc_quant_torch.data import native
from dlmc_quant_torch.data.loaders import (CIFAR_MEAN, CIFAR_STD,
                                           ArrayDataset, DataLoader,
                                           PrefetchLoader)
from test_torch_data_loaders import near_jax_native

REPO = Path(__file__).resolve().parent.parent
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
Image = pytest.importorskip("PIL.Image")


def _mk(n=64, h=32, w=32, c=3, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        imgs = rng.integers(0, 256, (n, h, w, c), np.uint8)
    else:
        imgs = rng.random((n, h, w, c), np.float32)
    return imgs, rng.integers(0, 10, n)


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


def test_both_libraries_build():
    assert native.available(), native.AUGMENT.error
    assert native.jpeg_available(), native.JPEG.error
    for source, link in (("augment.cpp", "-lpthread"),
                         ("jpegdec.cpp", "-ljpeg")):
        lib = native.library_path(source, link)
        assert lib.parent == native.BUILD_DIR and lib.is_file()
        assert re.fullmatch(rf"lib{source[:-4]}_[0-9a-f]{{12}}\.so",
                            lib.name)


# -- the batch assembly -----------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("augment", [False, True])
def test_native_matches_numpy(dtype, augment):
    """Bit for bit: the native pass divides by 255 and by ``std`` as the
    numpy path does (C10)."""
    imgs, labels = _mk(dtype=dtype)
    kw = dict(mean=CIFAR_MEAN, std=CIFAR_STD, train_augment=augment)
    ds_nat = ArrayDataset(imgs, labels, use_native=True, **kw)
    ds_np = ArrayDataset(imgs, labels, use_native=False, **kw)
    idx = np.arange(48)
    x1, y1 = ds_nat.get_batch(idx, np.random.default_rng(7))
    x2, y2 = ds_np.get_batch(idx, np.random.default_rng(7))
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_array_equal(_bits(x1), _bits(x2))


@pytest.mark.parametrize("pad", [0, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_native_near_jax_native(dtype, pad):
    """The same draws through the JAX package's native pass: within what
    its products (C10) move."""
    imgs, _ = _mk(n=40, dtype=dtype, seed=3)
    rng = np.random.default_rng(1)
    idx = rng.permutation(40)[:36]
    kw = dict(pad=pad, oy=rng.integers(0, 2 * pad + 1, 36),
              ox=rng.integers(0, 2 * pad + 1, 36), flip=rng.random(36) < .5,
              mean=CIFAR_MEAN, std=CIFAR_STD,
              scale255=dtype == np.uint8)
    near_jax_native(native.augment_gather(imgs, idx, **kw),
                    jnative.augment_gather(imgs, idx, **kw), CIFAR_STD,
                    dtype == np.uint8)
    # without a scale or a normalization both only gather, crop and flip
    kw.update(mean=None, std=None, scale255=False)
    np.testing.assert_array_equal(
        _bits(native.augment_gather(imgs, idx, **kw)),
        _bits(jnative.augment_gather(imgs, idx, **kw)))


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_native_threads_agree(threads):
    imgs, _ = _mk(n=50, seed=2)
    idx = np.arange(50)[::-1].copy()
    one = native.augment_gather(imgs, idx, mean=CIFAR_MEAN, std=CIFAR_STD,
                                scale255=True, n_threads=1)
    np.testing.assert_array_equal(
        _bits(one), _bits(native.augment_gather(
            imgs, idx, mean=CIFAR_MEAN, std=CIFAR_STD, scale255=True,
            n_threads=threads)))


def test_native_no_normalize_no_aug():
    imgs, labels = _mk(dtype=np.uint8)
    ds = ArrayDataset(imgs, labels, use_native=True)
    x, _ = ds.get_batch(np.arange(8), None)
    np.testing.assert_array_equal(x, imgs[:8].astype(np.float32) / 255.0)


def test_native_crop_borders_zero():
    """The largest offset pulls in the zero padding at the border."""
    imgs, _ = _mk(n=4)
    x = native.augment_gather(
        imgs, np.arange(4), pad=4,
        oy=np.zeros(4, np.int32), ox=np.zeros(4, np.int32),
        flip=np.zeros(4, np.uint8), scale255=True)
    assert np.all(x[:, :4, :, :] == 0)
    assert np.all(x[:, :, :4, :] == 0)
    np.testing.assert_array_equal(
        x[:, 4:, 4:, :], imgs[:, :-4, :-4, :].astype(np.float32) / 255.0)


def test_native_crop_out_of_range_rows_and_flip():
    """The other border, with a flip: the crop at offset 2·pad, mirrored."""
    imgs, _ = _mk(n=4)
    x = native.augment_gather(
        imgs, np.arange(4), pad=4, oy=np.full(4, 8, np.int32),
        ox=np.full(4, 8, np.int32), flip=np.ones(4, np.uint8), scale255=True)
    want = np.zeros_like(imgs, np.float32)
    want[:, :-4, :-4] = imgs[:, 4:, 4:] / np.float32(255.0)
    np.testing.assert_array_equal(x, want[:, :, ::-1])


def test_native_flip():
    imgs, _ = _mk(n=4)
    x = native.augment_gather(
        imgs, np.arange(4), flip=np.ones(4, np.uint8), scale255=True)
    np.testing.assert_array_equal(
        x, imgs[:, :, ::-1, :].astype(np.float32) / 255.0)


def test_native_gather_indices():
    imgs, _ = _mk(n=16)
    idx = np.array([3, 3, 0, 15], np.int64)
    x = native.augment_gather(imgs, idx, scale255=True)
    np.testing.assert_array_equal(x, imgs[idx].astype(np.float32) / 255.0)


def test_native_pad_needs_offsets():
    imgs, _ = _mk(n=4)
    with pytest.raises(ValueError, match="oy/ox"):
        native.augment_gather(imgs, np.arange(4), pad=2)


@pytest.mark.parametrize("bad", ["index", "negative", "offset", "length",
                                 "flip"])
def test_native_checks_what_it_reads(bad):
    """Nothing out of range reaches the pointers."""
    imgs, _ = _mk(n=4)
    kw = dict(pad=2, oy=np.zeros(4, np.int32), ox=np.full(4, 4, np.int32),
              flip=np.ones(4, np.uint8))
    idx = np.arange(4)
    if bad == "index":
        idx = np.array([0, 4])
    elif bad == "negative":
        idx = np.array([-1, 0])
    elif bad == "offset":
        kw["ox"] = np.full(4, 5, np.int32)
    elif bad == "length":
        kw["oy"] = np.zeros(3, np.int32)
    else:
        kw["flip"] = np.full(4, 2, np.uint8)
    if bad in ("index", "negative"):
        kw = {k: v[:2] for k, v in kw.items() if k != "pad"}
        kw["pad"] = 2
    with pytest.raises(IndexError if bad in ("index", "negative")
                       else ValueError):
        native.augment_gather(imgs, idx, **kw)
    native.augment_gather(imgs, np.arange(4), pad=2,
                          oy=np.zeros(4, np.int32),
                          ox=np.full(4, 4, np.int32),
                          flip=np.ones(4, np.uint8))


def test_prefetch_loader_same_batches():
    imgs, labels = _mk(n=100)
    ds = ArrayDataset(imgs, labels, train_augment=True, use_native=False)
    dl = DataLoader(ds, batch_size=32, shuffle=True, seed=3)
    plain = [(x.copy(), y.copy()) for x, y in dl]
    pre = list(dl.prefetch(depth=2))
    assert isinstance(dl.prefetch(), PrefetchLoader)
    assert len(plain) == len(pre)
    for (x1, y1), (x2, y2) in zip(plain, pre):
        np.testing.assert_array_equal(y1, y2)
        np.testing.assert_array_equal(x1, x2)


# -- the JPEG decoder -------------------------------------------------------

def _jpeg_bytes(img, mode=None, quality=95):
    buf = io.BytesIO()
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    im.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _smooth(seed=0, size=256, w=None):
    rng = np.random.default_rng(seed)
    base = rng.normal(128, 40, (8, 8, 3)).clip(0, 255)
    w = w or size
    return np.kron(base, np.ones((size // 8, w // 8, 1)))[
        :size, :w].astype(np.uint8)


def test_dims_and_full_resize_close_to_pil():
    data = _jpeg_bytes(_smooth())
    assert native.jpeg_dims(data) == (256, 256)
    out = native.jpeg_decode_resize(data, None, (224, 224))
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")
                     .resize((224, 224), Image.BILINEAR))
    assert out.shape == (224, 224, 3)
    assert np.abs(out.astype(int) - pil.astype(int)).mean() < 2.0


def test_crop_flip_close_to_pil():
    data = _jpeg_bytes(_smooth(seed=1))
    out = native.jpeg_decode_resize(data, (32, 16, 128, 128), (112, 112),
                                    flip=True)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")
                     .resize((112, 112), Image.BILINEAR,
                             box=(32, 16, 160, 144)))[:, ::-1]
    assert np.abs(out.astype(int) - pil.astype(int)).mean() < 2.0


def test_invalid_data_returns_none():
    assert native.jpeg_decode_resize(b"not a jpeg", None, (32, 32)) is None
    assert native.jpeg_dims(b"junk") is None


def _same_decode(data, crop, out_size, flip=False):
    got = native.jpeg_decode_resize(data, crop, out_size, flip)
    want = jnative.jpeg_decode_resize(data, crop, out_size, flip)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert native.jpeg_dims(data) == jnative.jpeg_dims(data)
    return got


@pytest.mark.parametrize("crop,out_size,flip", [
    (None, (224, 224), False),        # full frame, no DCT scaling
    (None, (100, 60), True),          # 1/2
    ((40, 10, 300, 280), (64, 64), False),   # 1/4
    ((5, 7, 400, 300), (32, 40), True),      # 1/8
    ((470, 300, 200, 200), (50, 50), False),  # clipped to the frame
    ((0, 0, 3, 2), (17, 9), True),    # upsampled
], ids=["full", "half", "quarter", "eighth", "clipped", "tiny"])
@pytest.mark.parametrize("mode", [None, "L"], ids=["rgb", "gray"])
def test_decode_equals_jax(crop, out_size, flip, mode):
    data = _jpeg_bytes(np.random.default_rng(5).integers(
        0, 256, (375, 500, 3), np.uint8), mode, quality=85)
    assert _same_decode(data, crop, out_size, flip) is not None


@pytest.mark.parametrize("cut", [0.97, 0.6, 0.2, 0.01])
def test_truncated_equals_jax(cut):
    """libjpeg warns on a premature end and fills the rest; before the
    first scan it fails: the same array or None on both sides."""
    data = _jpeg_bytes(_smooth(seed=2, size=128, w=96))
    _same_decode(data[:int(len(data) * cut)], (8, 8, 80, 100), (48, 40))


@pytest.mark.parametrize("data", [
    b"", b"\xff\xd8", b"\xff\xd8\xff\xe0" + bytes(200),
    bytes(np.random.default_rng(0).integers(0, 256, 4096, np.uint8))],
    ids=["empty", "soi", "app0", "noise"])
def test_garbage_equals_jax(data):
    assert _same_decode(data, None, (16, 16)) is None


def test_cmyk_fails_as_jax():
    data = _jpeg_bytes(_smooth(seed=3, size=64), "CMYK")
    assert native.jpeg_dims(data) == jnative.jpeg_dims(data) == (64, 64)
    assert _same_decode(data, None, (32, 32)) is None


def test_jpegdec_keeps_no_destructor_across_setjmp():
    """C5: the frame is a malloc'd buffer freed on both exits; no
    ``std::vector`` (or other object with a destructor) in the source."""
    src = (Path(native.__file__).parent / "jpegdec.cpp").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert "std::vector" not in code and "<vector>" not in code
    assert "std::string" not in code and "unique_ptr" not in code
    assert code.count("std::free(") == 2


# -- the build --------------------------------------------------------------

def test_build_by_hash_and_rename(tmp_path):
    """Two processes build the same source into an empty directory at once:
    both load the library (each renames a whole file into place), no
    temporary file is left, and the name is the hash of the source and the
    command."""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        from dlmc_quant_torch.data import native
        native.BUILD_DIR = Path({str(tmp_path)!r})
        lib = native.build("augment.cpp", "-lpthread")
        assert native.AUGMENT.load() is not None, native.AUGMENT.error
        print(lib.name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=ONE_THREAD, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    names = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-2000:]
        names.append(out.strip())
    assert names[0] == names[1] == native.library_path(
        "augment.cpp", "-lpthread").name
    assert [f.name for f in tmp_path.iterdir()] == [names[0]]


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    src = (native.HERE / "augment.cpp").read_bytes()
    real = native.library_path("augment.cpp", "-lpthread")
    (tmp_path / "augment.cpp").write_bytes(src)
    monkeypatch.setattr(native, "HERE", tmp_path)
    assert native.library_path("augment.cpp", "-lpthread") == real
    (tmp_path / "augment.cpp").write_bytes(src + b"\n// edited\n")
    edited = native.library_path("augment.cpp", "-lpthread")
    assert edited != real
    assert native.library_path("augment.cpp", "-lm") != edited


def test_no_native_switch():
    """``DLMCQ_NO_NATIVE=1``: neither library loads, the array datasets
    take the numpy path and a folder dataset decodes with PIL."""
    code = textwrap.dedent("""
        import numpy as np
        from dlmc_quant_torch.data import native
        from dlmc_quant_torch.data.loaders import (ArrayDataset, CIFAR10,
                                                   ImageFolderDataset)
        assert not native.available() and not native.jpeg_available()
        assert native.AUGMENT.error == "DLMCQ_NO_NATIVE=1"
        assert not ArrayDataset(np.zeros((2, 4, 4, 3), np.uint8),
                                np.zeros(2)).use_native
        assert not ImageFolderDataset([], []).native_decode
        x, _ = next(iter(CIFAR10(data_dir="none", n_samples=16,
                                 batch_size=8)))
        assert x.shape == (8, 32, 32, 3)
    """)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env=dict(ONE_THREAD, DLMCQ_NO_NATIVE="1"))


def test_failed_build_leaves_numpy_path(tmp_path, monkeypatch):
    """A source that does not compile: ``build`` raises with the
    compiler's report, the library stays unavailable and says why."""
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(native, "HERE", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build("broken.cpp", "-lpthread")
    lib = native._Native("broken.cpp", "-lpthread", "v", lambda lib: None)
    assert lib.load() is None and "failed" in lib.error
    assert not any((tmp_path / "_build").iterdir())
