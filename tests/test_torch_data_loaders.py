"""The port's loader factories against the JAX package's, on data that the
tests write in the datasets' own formats: CIFAR-10's and CIFAR-100's python
pickles (a few dozen images a batch file), MNIST's idx files plain and
gzipped, ``Synthetic`` and the synthetic fallbacks.

Every batch, over two epochs, augmentation included, must equal the JAX
package's numpy path (``ArrayDataset(use_native=False)``) bit for bit,
through the port's native batch assembly and through its numpy path.  The
JAX package's native pass multiplies by ``1/std`` (ROADMAP hazard C10), so
against it one ulp is allowed.  Also: ``n_samples`` with and without
``random_sample``, ``validation_split`` through a prefetched loader,
``shard``, ``get_dataloader`` by all five names with JAX's signatures, the
prefetch thread's errors, and the classification entry reading a CIFAR
folder on the CPU.
"""

import gzip
import inspect
import os
import pickle
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dlmc_quant_tpu.data import loaders as J
from dlmc_quant_torch.data import loaders as L
from dlmc_quant_torch.data import native

REPO = Path(__file__).resolve().parent.parent
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
# images a CIFAR batch file / test file, MNIST's training and test images
CIFAR_BATCH, CIFAR_TEST, MNIST_TRAIN, MNIST_TEST = 24, 20, 40, 20
NAMES = ("Mnist", "CIFAR10", "CIFAR100", "ImageNet", "Synthetic")


def _cifar_file(path: Path, n: int, rng, label_keys):
    """A batch file as CIFAR's own: a pickled dict with bytes keys, the
    images as rows of 3072 bytes (the R plane, then G, then B)."""
    d = {b"batch_label": b"testing batch",
         b"data": rng.integers(0, 256, (n, 3072), np.uint8),
         b"filenames": [b"img_%d.png" % i for i in range(n)]}
    for key, classes in label_keys:
        d[key] = [int(v) for v in rng.integers(0, classes, n)]
    with open(path, "wb") as f:
        pickle.dump(d, f, protocol=2)
    return d


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    rng = np.random.default_rng(0)
    c10, c100 = root / "cifar-10-batches-py", root / "cifar-100-python"
    c10.mkdir()
    c100.mkdir()
    written = {}
    for i in range(1, 6):
        written[f"data_batch_{i}"] = _cifar_file(
            c10 / f"data_batch_{i}", CIFAR_BATCH, rng, [(b"labels", 10)])
    written["test_batch"] = _cifar_file(c10 / "test_batch", CIFAR_TEST, rng,
                                        [(b"labels", 10)])
    for name, n in (("train", 3 * CIFAR_BATCH), ("test", CIFAR_TEST)):
        written[name] = _cifar_file(c100 / name, n, rng,
                                    [(b"fine_labels", 100),
                                     (b"coarse_labels", 20)])
    return root, written


def _idx(path: Path, a: np.ndarray):
    """An idx file: magic 0x0000 08 <ndim>, big-endian dims, uint8 data."""
    op = gzip.open if path.suffix == ".gz" else open
    with op(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | a.ndim))
        for d in a.shape:
            f.write(struct.pack(">I", d))
        f.write(a.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def mnist_dirs(tmp_path_factory):
    rng = np.random.default_rng(1)
    arrays = {p: (rng.integers(0, 256, (n, 28, 28), np.uint8),
                  rng.integers(0, 10, n).astype(np.uint8))
              for p, n in (("train", MNIST_TRAIN), ("t10k", MNIST_TEST))}
    dirs = {}
    for suffix in ("", ".gz"):
        root = tmp_path_factory.mktemp("mnist")
        raw = root / "MNIST" / "raw"
        raw.mkdir(parents=True)
        for prefix, (x, y) in arrays.items():
            _idx(raw / f"{prefix}-images-idx3-ubyte{suffix}", x)
            _idx(raw / f"{prefix}-labels-idx1-ubyte{suffix}", y)
        dirs[suffix or "plain"] = root
    return dirs, arrays


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


def near_jax_native(x, xr, std, scaled: bool):
    """``x`` as far from the JAX package's native pass ``xr`` as C10 lets
    it be.  That pass multiplies by ``1/std`` where numpy divides, one ulp
    of the result; from 8-bit images it also multiplies by ``1/255``, one
    ulp of a value ≤ 1, which the subtraction of the mean then keeps while
    the value shrinks (thousands of the result's ulps near ``mean``): so
    that ulp is carried through ``/std``, and two of the result's are
    allowed for the rounding after it."""
    if not scaled:
        np.testing.assert_array_max_ulp(x, xr, maxulp=1)
        return
    bound = (np.spacing(np.float32(1)) / np.asarray(std, np.float64)
             + 2 * np.spacing(np.abs(xr)))
    gap = np.abs(x.astype(np.float64) - xr)
    assert (gap <= bound).all(), float((gap / bound).max())


def _same(port, ref, exact=True, epochs=(0, 1)):
    """Every batch of ``port`` equals ``ref``'s over ``epochs``: bit for bit,
    or (``exact=False``, ``ref`` the JAX package's native pass) as close as
    C10 lets it be."""
    assert len(port) == len(ref) > 0
    for epoch in epochs:
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        n = 0
        for (x, y), (xr, yr) in zip(port, ref):
            assert x.dtype == xr.dtype == np.float32 and x.shape == xr.shape
            if exact:
                np.testing.assert_array_equal(_bits(x), _bits(xr))
            else:
                ds = ref.dataset
                near_jax_native(x, xr, ds.std, ds._scale255)
            np.testing.assert_array_equal(y, yr)
            assert y.dtype == yr.dtype == np.int32
            n += 1
        assert n == len(ref)


def _pair(name, port_native, **kw):
    """(the port's loader, JAX's on its numpy path, JAX's native) of one
    factory and arguments; the port's on its native pass or its numpy
    path."""
    port = L.get_dataloader(name, **kw)
    port.dataset.use_native = port_native
    ref, ref_native = (J.get_dataloader(name, **kw) for _ in range(2))
    ref.dataset.use_native = False
    assert ref_native.dataset.use_native
    return port, ref, ref_native


def test_native_batch_assembly_is_built():
    assert native.available(), native.AUGMENT.error
    assert L.ArrayDataset(np.zeros((2, 4, 4, 3), np.uint8),
                          np.zeros(2)).use_native


@pytest.mark.parametrize("port_native", [True, False],
                         ids=["native", "numpy"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["CIFAR10", "CIFAR100"])
def test_cifar_pickles_match_jax(cifar_dir, name, training, port_native):
    root, written = cifar_dir
    port, ref, ref_native = _pair(name, port_native, data_dir=str(root),
                                  batch_size=16, training=training,
                                  synthetic_fallback=False, seed=5)
    files = ({"CIFAR10": [f"data_batch_{i}" for i in range(1, 6)],
              "CIFAR100": ["train"]} if training else
             {"CIFAR10": ["test_batch"], "CIFAR100": ["test"]})[name]
    key = b"labels" if name == "CIFAR10" else b"fine_labels"
    want = np.concatenate([written[f][b"data"] for f in files])
    ds = port.dataset
    assert ds.images.dtype == np.uint8 and ds.images.shape[1:] == (32, 32, 3)
    np.testing.assert_array_equal(
        ds.images, want.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(
        ds.labels, np.concatenate([written[f][key] for f in files]))
    _same(port, ref)
    _same(port, ref_native, exact=False)


@pytest.mark.parametrize("random_sample", [True, False],
                         ids=["random", "first"])
def test_cifar_n_samples_match_jax(cifar_dir, random_sample):
    root, _ = cifar_dir
    port, ref, _ = _pair("CIFAR10", True, data_dir=str(root), batch_size=8,
                         n_samples=40, random_sample=random_sample, seed=7)
    assert port.n_samples == ref.n_samples == 40
    np.testing.assert_array_equal(port.dataset.images, ref.dataset.images)
    _same(port, ref)


@pytest.mark.parametrize("fallback", [True, False])
def test_cifar_falls_back_only_without_files(tmp_path, fallback):
    """An empty folder: the synthetic data with ``synthetic_fallback``
    (the JAX package's, batch for batch), else ``FileNotFoundError``."""
    (tmp_path / "cifar-10-batches-py").mkdir()
    kw = dict(data_dir=str(tmp_path), batch_size=16, n_samples=48,
              synthetic_fallback=fallback)
    if not fallback:
        with pytest.raises(FileNotFoundError):
            L.CIFAR10(**kw)
        return
    port, ref, _ = _pair("CIFAR10", True, **kw)
    assert port.dataset.images.dtype == np.float32
    _same(port, ref)


@pytest.mark.parametrize("port_native", [True, False],
                         ids=["native", "numpy"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["plain", ".gz"])
def test_mnist_idx_matches_jax(mnist_dirs, kind, training, port_native):
    dirs, arrays = mnist_dirs
    port, ref, ref_native = _pair("Mnist", port_native,
                                  data_dir=str(dirs[kind]), batch_size=8,
                                  training=training,
                                  synthetic_fallback=False, seed=2)
    x, y = arrays["train" if training else "t10k"]
    np.testing.assert_array_equal(port.dataset.images, x[..., None])
    np.testing.assert_array_equal(port.dataset.labels, y)
    _same(port, ref)
    _same(port, ref_native, exact=False)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_mnist_fallback_matches_jax(tmp_path, training):
    port, ref, _ = _pair("Mnist", True, data_dir=str(tmp_path),
                         batch_size=500, training=training)
    assert len(port.dataset) == (6000 if training else 1000)
    _same(port, ref, epochs=(0,))
    with pytest.raises(FileNotFoundError):
        L.Mnist(data_dir=str(tmp_path), synthetic_fallback=False)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_synthetic_matches_jax(training):
    kw = dict(batch_size=8, image_size=16, num_classes=10, length=100,
              materialized=40, training=training, seed=4, num_workers=3)
    port, ref, ref_native = _pair("Synthetic", True, **kw)
    assert len(port.dataset) == 40
    _same(port, ref)
    _same(port, ref_native, exact=False)


def test_validation_split_through_prefetch(cifar_dir):
    """A prefetched loader proxies ``len``, ``set_epoch`` and
    ``split_validation``, as the trainer and the classification entry use
    them; its batches are the plain loader's and JAX's."""
    root, _ = cifar_dir
    kw = dict(data_dir=str(root), batch_size=16, validation_split=0.25,
              seed=3)
    plain, ref, _ = _pair("CIFAR10", True, **kw)
    pre = plain.prefetch(3)
    assert isinstance(pre, L.PrefetchLoader) and len(pre) == len(plain)
    assert pre.n_samples == ref.n_samples == 90
    _same(pre, ref)
    val, ref_val = pre.split_validation(), ref.split_validation()
    np.testing.assert_array_equal(val.indices, ref_val.indices)
    ref_val.dataset.use_native = False
    _same(val.prefetch(), ref_val)


def test_shard_matches_jax(cifar_dir):
    root, _ = cifar_dir
    port, ref, _ = _pair("CIFAR10", True, data_dir=str(root), batch_size=8,
                         seed=9)
    for rank in range(3):
        s, r = port.shard(rank, 3), ref.shard(rank, 3)
        np.testing.assert_array_equal(s.indices, r.indices)
        _same(s, r)


def _args(name, tmp_path, cifar_root, mnist_root):
    return {"Mnist": dict(data_dir=str(mnist_root), batch_size=8),
            "CIFAR10": dict(data_dir=str(cifar_root), batch_size=8),
            "CIFAR100": dict(data_dir=str(cifar_root), batch_size=8),
            "ImageNet": dict(data_dir=str(tmp_path / "none"), batch_size=4,
                             size=16, n_samples=12, num_workers=2),
            "Synthetic": dict(batch_size=4, image_size=16, num_classes=10,
                              materialized=12)}[name]


@pytest.mark.parametrize("name", NAMES)
def test_get_dataloader_by_name(name, tmp_path, cifar_dir, mnist_dirs):
    """Every name of the JAX package's ``DATALOADERS`` with its signature;
    the first batch is JAX's."""
    assert list(L.DATALOADERS) == list(J.DATALOADERS)
    port_sig = inspect.signature(L.DATALOADERS[name])
    jax_sig = inspect.signature(J.DATALOADERS[name])
    assert [(p.name, p.kind, p.default)
            for p in port_sig.parameters.values()] == \
        [(p.name, p.kind, p.default) for p in jax_sig.parameters.values()]
    kw = _args(name, tmp_path, cifar_dir[0], mnist_dirs[0]["plain"])
    port, ref, _ = _pair(name, True, **kw)
    (x, y), (xr, yr) = next(iter(port)), next(iter(ref))
    np.testing.assert_array_equal(_bits(x), _bits(xr))
    np.testing.assert_array_equal(y, yr)
    with pytest.raises(ValueError, match="unknown dataloader"):
        L.get_dataloader(name.lower() + "_x")


def test_prefetch_raises_the_workers_error():
    class Broken:
        def __len__(self):
            return 3

        def __iter__(self):
            yield np.zeros(1), np.zeros(1)
            raise OSError("disk gone")

    it = iter(L.PrefetchLoader(Broken(), 2))
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_classification_entry_reads_a_cifar_folder(cifar_dir, tmp_path):
    """``python -m dlmc_quant_torch.examples.classification --device cpu``
    on the fp32 baseline's YAML pointed at the written pickles: its
    loaders hold the files' images, and one epoch runs to finite metrics.
    A ``tensorboard`` stub that fails to import comes first on the child's
    path (the real one pulls in TensorFlow)."""
    from dlmc_quant_torch.examples import classification
    from dlmc_quant_torch.utils.config import (ConfigParser, read_yaml,
                                               write_yaml)
    root, written = cifar_dir
    cfg = read_yaml(REPO / "examples" / "configs"
                    / "baseline_resnet20_cifar10.yaml")
    cfg["train_loader"]["args"].update(data_dir=str(root), batch_size=16)
    cfg["n_runs"] = 1
    cfg["trainer"].update(epochs=1, save_period=1)
    cfg["save_dir"] = str(tmp_path / "saved")
    _, _, _, train, valid = classification.build_common(
        ConfigParser(cfg, "cpu", save_to_disk=False), "cpu")
    want = np.concatenate([written[f"data_batch_{i}"][b"data"]
                           for i in range(1, 6)])
    np.testing.assert_array_equal(
        train.dataset.images,
        want.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
    assert train.n_samples + valid.n_samples == 5 * CIFAR_BATCH
    path = tmp_path / "cfg.yaml"
    write_yaml(cfg, path)
    stub = tmp_path / "stub" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('raise ImportError("stubbed out")\n')
    env = dict(ONE_THREAD, PYTHONPATH=os.pathsep.join(
        filter(None, [str(stub.parent), os.environ.get("PYTHONPATH")])))
    run = subprocess.run(
        [sys.executable, "-m", "dlmc_quant_torch.examples.classification",
         "-c", str(path), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    assert "run 0 final:" in run.stdout and "nan" not in run.stdout
