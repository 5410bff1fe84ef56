"""Numpy datasets and batch loaders, on the host.

Counterpart of ``dlmc_quant_tpu/data/loaders.py`` (a copy: that module is
numpy-only, but importing it would import the JAX package).  The readers
take real data from disk first: CIFAR-10/100's python pickles, MNIST's idx
files (plain or gzipped) and an ImageNet folder (``<data_dir>/train|val/
<class>/<image>``), streamed and decoded a batch at a time.  With no data
on disk they fall back to seeded synthetic data (the ``'easy'`` or
``'hard'`` profile), array for array the JAX package's.  Batches are numpy
(N, H, W, C) float32 and int32 labels; the caller moves them to its device.

Every batch equals the JAX package's numpy path bit for bit: the same
draws in the same order, and the native batch assembly
(``data/native/augment.cpp``) computes what that path computes.  The JAX
package's own native pass multiplies by ``1/std`` and may sit one ulp away
(ROADMAP hazard C10).

``validation_split`` holds out a seeded share of the training set (the
same indices as the JAX package's), which ``split_validation()`` serves;
``prefetch(depth)`` assembles batches on a background thread.
ref: base/base_data_loader.py:7-64, data_loader/data_loaders.py:9-89,
example/benchmark/benchmark.py:35-54.
"""

from __future__ import annotations

import gzip
import pickle
import queue
import struct
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from dlmc_quant_torch.data import native

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
MNIST_MEAN, MNIST_STD = np.float32(0.1307), np.float32(0.3081)


class ArrayDataset:
    """In-memory dataset: images (N,H,W,C) uint8/float32 + labels (N,).

    A batch is gathered, scaled by 1/255 if the images are 8-bit, and with
    ``train_augment`` pad-cropped and flipped, then normalized: in one
    threaded native pass where ``use_native`` (by default, where the
    library builds), else in numpy.  Both draw the same randomness in the
    same order and give the same bits.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 mean=None, std=None, train_augment: bool = False,
                 pad: int = 4, use_native: Optional[bool] = None):
        assert len(images) == len(labels)
        self.images = images
        self.labels = np.asarray(labels, np.int32)
        self.mean = mean
        self.std = std
        self.train_augment = train_augment
        self.pad = pad
        self._scale255 = (images.dtype == np.uint8
                          or float(images[:16].max(initial=0.0)) > 2.0)
        self.use_native = (native.available() if use_native is None
                           else use_native)

    def __len__(self):
        return len(self.images)

    def get_batch(self, idx: np.ndarray, rng: Optional[np.random.Generator]
                  ) -> Tuple[np.ndarray, np.ndarray]:
        aug = self.train_augment and rng is not None
        oy = ox = flip = None
        if aug:
            n = len(idx)
            oy = rng.integers(0, 2 * self.pad + 1, n)
            ox = rng.integers(0, 2 * self.pad + 1, n)
            flip = rng.random(n) < 0.5
        if self.use_native:
            x = native.augment_gather(
                self.images, idx, pad=self.pad if aug else 0, oy=oy, ox=ox,
                flip=flip, mean=self.mean, std=self.std,
                scale255=self._scale255)
            return x, self.labels[idx]
        x = self.images[idx].astype(np.float32)
        if self._scale255:
            x = x / 255.0
        if aug:
            x = self._augment(x, oy, ox, flip)
        if self.mean is not None:
            x = (x - self.mean) / self.std
        return x, self.labels[idx]

    def _augment(self, x, oy, ox, flip):
        """Random crop (zero-pad) + horizontal flip."""
        n, h, w, _ = x.shape
        p = self.pad
        xp = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
        out = np.empty_like(x)
        for i in range(n):
            out[i] = xp[i, oy[i]:oy[i] + h, ox[i]:ox[i] + w]
        out[flip] = out[flip, :, ::-1]
        return out


class DataLoader:
    """Seeded batch iterator: a fresh shuffle each epoch, optional
    ``drop_last``, and a validation split: ``validation_split`` (a share,
    or a count when ≥ 1) of the indices, shuffled once with seed 0, go to
    the loader that :meth:`split_validation` returns.
    ref: base/base_data_loader.py:7-64"""

    def __init__(self, dataset, batch_size: int = 128,
                 shuffle: bool = True, validation_split: float = 0.0,
                 drop_last: bool = True, seed: int = 0,
                 indices: Optional[np.ndarray] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0
        self._val_indices = None
        if indices is not None:
            self.indices = np.asarray(indices)
            return
        all_idx = np.arange(len(dataset))
        self.indices = all_idx
        if validation_split:
            n_val = (int(validation_split) if validation_split >= 1
                     else int(len(dataset) * validation_split))
            np.random.default_rng(0).shuffle(all_idx)   # a fixed split
            self._val_indices = all_idx[:n_val]
            self.indices = all_idx[n_val:]

    def split_validation(self) -> Optional["DataLoader"]:
        """The held-out indices' loader (in order, every batch kept), or
        None without a split."""
        if self._val_indices is None:
            return None
        return DataLoader(self.dataset, self.batch_size, shuffle=False,
                          indices=self._val_indices, drop_last=False)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    @property
    def n_samples(self) -> int:
        return len(self.indices)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self.indices.copy()
        rng = np.random.default_rng((self.seed, self._epoch))
        if self.shuffle:
            rng.shuffle(idx)
        for b in range(len(self)):
            batch_idx = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.dataset.get_batch(
                batch_idx, rng if self.dataset.train_augment else None)

    def shard(self, process_index: int, process_count: int) -> "DataLoader":
        """This rank's share of the data: every ``process_count``-th index
        from ``process_index``, shuffled with seed ``seed + process_index``
        (ref: DistributedSampler, DDP_RootQ_train.py:81-97)."""
        return DataLoader(self.dataset, self.batch_size, self.shuffle,
                          indices=self.indices[process_index::process_count],
                          drop_last=self.drop_last,
                          seed=self.seed + process_index)

    def prefetch(self, depth: int = 2) -> "PrefetchLoader":
        """This loader with its batches assembled ``depth`` ahead on a
        background thread (the native passes release the GIL)."""
        return PrefetchLoader(self, depth)


class PrefetchLoader:
    """Iterates the wrapped loader on a background thread, at most
    ``depth`` batches ahead, so that the host assembles the next batches
    while the device runs the current step.  Proxies the wrapped loader's
    attributes (``len``, ``set_epoch``, ``split_validation``, ...); an error
    in the thread is raised in the consumer, and a consumer that stops
    early (``close()``) ends the thread."""

    def __init__(self, loader: DataLoader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        stop = threading.Event()

        def worker():
            try:
                for item in self.loader:
                    q.put(item)
                    if stop.is_set():
                        return
                q.put(end)
            except BaseException as e:  # raised in the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # left early (closed, or an error): drain until the thread has
            # seen ``stop``, so that it ends instead of blocking on a full
            # queue with its batches
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()


class ImageFolderDataset:
    """An image folder streamed a batch at a time: O(batch) memory.

    Holds file paths and labels only; ``get_batch`` decodes the batch's
    images on a thread pool and transforms them:

      train: RandomResizedCrop(size, scale=(0.08, 1)) + random hflip
             (ref: data_loader/data_loaders.py:66-70)
      eval:  Resize(size/0.875) + CenterCrop(size)
             (ref: data_loader/data_loaders.py:71-77)

    ``native_decode`` (by default, where the decoder builds) decodes JPEGs
    with libjpeg (``data/native/jpegdec.cpp``), crop and resize fused;
    else, and for any image it cannot decode, PIL does.  Each image's
    train geometry comes from a child stream of the batch's generator
    (``rng.spawn``), so the batch does not depend on the order in which the
    threads finish.
    """

    def __init__(self, paths, labels, size: int = 224, mean=None, std=None,
                 train_augment: bool = False, num_workers: int = 8,
                 native_decode: Optional[bool] = None):
        self.paths = list(paths)
        self.labels = np.asarray(labels, np.int32)
        self.size = size
        self.mean = mean
        self.std = std
        self.train_augment = train_augment
        self.num_workers = max(int(num_workers), 1)
        if native_decode is None:
            native_decode = native.jpeg_available()
        self.native_decode = bool(native_decode)
        self._pool = None

    def __len__(self):
        return len(self.paths)

    def __getstate__(self):     # a copy leaves the live pool behind
        d = dict(self.__dict__)
        d["_pool"] = None
        return d

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                            thread_name_prefix="imgdecode")
        return self._pool

    # -- transforms ------------------------------------------------------

    def _rrc_params(self, w, h, rng):
        """RandomResizedCrop's box: area share U(0.08, 1), log-uniform
        aspect in (3/4, 4/3), 10 tries, then the centre fallback."""
        area = w * h
        for _ in range(10):
            target = area * rng.uniform(0.08, 1.0)
            aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * aspect)))
            ch = int(round(np.sqrt(target / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = int(rng.integers(0, w - cw + 1))
                top = int(rng.integers(0, h - ch + 1))
                return left, top, cw, ch
        # the largest centred crop within the aspect bounds
        in_ratio = w / h
        if in_ratio < 3 / 4:
            cw, ch = w, min(int(round(w / (3 / 4))), h)
        elif in_ratio > 4 / 3:
            cw, ch = min(int(round(h * (4 / 3))), w), h
        else:
            cw, ch = w, h
        return (w - cw) // 2, (h - ch) // 2, cw, ch

    def _read(self, path):
        """The file's bytes and (width, height) from the native decoder's
        header read, or (None, None) where it cannot."""
        if not (self.native_decode and native.jpeg_available()):
            return None, None
        try:
            data = Path(path).read_bytes()
        except OSError:
            return None, None
        dims = native.jpeg_dims(data)
        return (data, dims) if dims is not None else (None, None)

    def _decode_train(self, path, left, top, cw, ch, flip,
                      data: Optional[bytes] = None):
        if data is not None:
            out = native.jpeg_decode_resize(
                data, (left, top, cw, ch), (self.size, self.size), flip)
            if out is not None:
                return out
        from PIL import Image
        im = Image.open(path).convert("RGB")
        im = im.resize((self.size, self.size), Image.BILINEAR,
                       box=(left, top, left + cw, top + ch))
        a = np.asarray(im, np.uint8)
        return a[:, ::-1] if flip else a

    def _decode_eval(self, path):
        size = self.size
        resize = int(size / 0.875)
        data, dims = self._read(path)
        if dims is not None:
            # the shorter side resized, then the centre crop: one fused
            # crop + resize of a centred box of side min(w, h)·size/resize
            w, h = dims
            side = round(min(w, h) * size / resize)
            left, top = (w - side) // 2, (h - side) // 2
            out = native.jpeg_decode_resize(
                data, (left, top, side, side), (size, size))
            if out is not None:
                return out
        from PIL import Image
        im = Image.open(path).convert("RGB")
        w, h = im.size
        scale = resize / min(w, h)
        im = im.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
        w, h = im.size
        left, top = (w - size) // 2, (h - size) // 2
        im = im.crop((left, top, left + size, top + size))
        return np.asarray(im, np.uint8)

    def _train_job(self, i, rng):
        """One image of a train batch: its size read from the header (on
        the worker: read serially it throttles the pool), its box and flip
        from its own stream, then the decode."""
        path = self.paths[i]
        data, dims = self._read(path)
        if dims is not None:
            w, h = dims
        else:
            from PIL import Image
            with Image.open(path) as im:
                w, h = im.size
        left, top, cw, ch = self._rrc_params(w, h, rng)
        flip = bool(rng.random() < 0.5)
        return self._decode_train(path, left, top, cw, ch, flip, data=data)

    # -- batch API (ArrayDataset's protocol) -------------------------------

    def decode(self, idx: np.ndarray, rng: Optional[np.random.Generator]):
        """The batch's uint8 images (N, size, size, 3), before the scale
        and the normalization."""
        pool = self._ensure_pool()
        if self.train_augment and rng is not None:
            imgs = pool.map(self._train_job, idx, rng.spawn(len(idx)))
        else:
            imgs = pool.map(self._decode_eval, [self.paths[i] for i in idx])
        return np.stack(list(imgs))

    def get_batch(self, idx: np.ndarray,
                  rng: Optional[np.random.Generator]):
        batch = self.decode(idx, rng)
        if native.available():
            x = native.augment_gather(
                batch, np.arange(len(batch), dtype=np.int64),
                mean=self.mean, std=self.std, scale255=True)
            return x, self.labels[idx]
        x = batch.astype(np.float32) / 255.0
        if self.mean is not None:
            x = (x - self.mean) / self.std
        return x, self.labels[idx]


def scan_image_folder(split_dir: Path):
    """An ImageFolder layout's (paths, labels, classes): classes are the
    sorted subfolders, images sorted within each."""
    classes = sorted(p.name for p in split_dir.iterdir() if p.is_dir())
    paths, labels = [], []
    for i, c in enumerate(classes):
        for p in sorted((split_dir / c).iterdir()):
            paths.append(p)
            labels.append(i)
    return paths, np.asarray(labels), classes


# ---------------------------------------------------------------------------
# dataset readers
# ---------------------------------------------------------------------------

def _load_cifar_python(data_dir: Path, train: bool, n_classes: int):
    """CIFAR-10/100's python-pickle format: images (N, 32, 32, 3) uint8
    and labels (``fine_labels`` for CIFAR-100)."""
    if n_classes == 10:
        files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        root = data_dir / "cifar-10-batches-py"
        label_key = b"labels"
    else:
        files = ["train"] if train else ["test"]
        root = data_dir / "cifar-100-python"
        label_key = b"fine_labels"
    xs, ys = [], []
    for fn in files:
        with open(root / fn, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.extend(d[label_key])
    return np.concatenate(xs), np.asarray(ys)


def _read_idx(path: Path) -> np.ndarray:
    """An idx file (MNIST's format), plain or gzipped."""
    op = gzip.open if path.suffix == ".gz" else open
    with op(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(magic & 0xFF)]
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _find_idx(root: Path, stem: str) -> Path:
    for suffix in ("", ".gz"):
        p = root / (stem + suffix)
        if p.exists():
            return p
    raise FileNotFoundError(root / stem)


def _synthetic_classification(n: int, image_size, num_classes: int,
                              seed: int = 0, profile: str = "easy",
                              split: str = "train"):
    """Learnable synthetic data: per-class mean patterns + noise.

    The prototypes come from ``seed`` alone, so train and eval share them;
    labels and noise come from a stream of their own per split.  Profiles:
    ``'easy'``, full-image iid prototypes and low noise (any model
    saturates); ``'hard'``, class signal in a low-rank, low-frequency
    subspace under strong noise, so that fp32 accuracy stays well below
    100 % (the JAX package's accuracy protocol).
    """
    h, w, c = image_size
    rng = np.random.default_rng(seed)
    srng = np.random.default_rng((seed, 0 if split == "train" else 1))
    labels = srng.integers(0, num_classes, n)
    if profile == "hard":
        k, amp, sigma, base = 16, 1.5, 0.40, 8
        lo = rng.normal(0.0, 1.0, (k, base, base, c)).astype(np.float32)
        basis = lo[:, (np.arange(h) * base) // h][
            :, :, (np.arange(w) * base) // w]
        basis /= np.linalg.norm(basis.reshape(k, -1), axis=1).reshape(
            k, 1, 1, 1)
        coef = rng.normal(0.0, 1.0, (num_classes, k)).astype(np.float32)
        protos = 0.5 + amp * np.einsum("mk,khwc->mhwc", coef, basis)
        images = protos[labels] + srng.normal(0, sigma, (n, h, w, c))
    elif profile == "easy":
        protos = rng.normal(0.5, 0.25,
                            (num_classes, h, w, c)).astype(np.float32)
        images = protos[labels] + srng.normal(0, 0.25, (n, h, w, c))
    else:
        raise ValueError(f"unknown synthetic profile {profile!r}")
    return np.clip(images, 0, 1).astype(np.float32), labels


def _subsample(images, labels, n_samples: Optional[int],
               random_sample: bool, seed: int = 0):
    """The first ``n_samples``, or as many drawn at random
    (ref: data_loaders.py:61-89)."""
    if not n_samples or n_samples >= len(images):
        return images, labels
    if random_sample:
        idx = np.random.default_rng(seed).choice(len(images), n_samples,
                                                 replace=False)
    else:
        idx = np.arange(n_samples)
    return images[idx], labels[idx]


# ---------------------------------------------------------------------------
# loader factories (the YAML-facing API; ref: data_loader/data_loaders.py)
# ---------------------------------------------------------------------------

def CIFAR10(data_dir: str = "data", batch_size: int = 128,
            shuffle: bool = True, validation_split: float = 0.0,
            training: bool = True, n_samples: Optional[int] = None,
            random_sample: bool = False, num_workers: int = 0,
            synthetic_fallback: bool = True, seed: int = 0,
            synthetic_profile: str = "easy",
            _n_classes: int = 10) -> DataLoader:
    """CIFAR-10 (``_n_classes=100``: CIFAR-100) at 32², read from
    ``<data_dir>/cifar-10-batches-py`` (``cifar-100-python``); where those
    files cannot be read, and ``synthetic_fallback`` is set, the seeded
    synthetic fallback (10000 training or 2000 eval images).  Then
    ``n_samples`` of them.  The training loader shuffles, pad-crops and
    flips, and drops the last partial batch.  ``num_workers`` is accepted
    for the YAMLs' sake: the batch assembly's threads are the native
    pass's."""
    try:
        images, labels = _load_cifar_python(Path(data_dir), training,
                                            _n_classes)
    except (FileNotFoundError, OSError):
        if not synthetic_fallback:
            raise
        images, labels = _synthetic_classification(
            10000 if training else 2000, (32, 32, 3), _n_classes, seed,
            profile=synthetic_profile, split="train" if training else "eval")
    images, labels = _subsample(images, labels, n_samples, random_sample,
                                seed)
    ds = ArrayDataset(images, labels, CIFAR_MEAN, CIFAR_STD,
                      train_augment=training)
    return DataLoader(ds, batch_size, shuffle and training, validation_split,
                      drop_last=training, seed=seed)


def CIFAR100(**kw) -> DataLoader:
    return CIFAR10(_n_classes=100, **kw)


def Mnist(data_dir: str = "data", batch_size: int = 128,
          shuffle: bool = True, validation_split: float = 0.0,
          training: bool = True, synthetic_fallback: bool = True,
          num_workers: int = 0, seed: int = 0) -> DataLoader:
    """MNIST at 28²×1 from ``<data_dir>/MNIST/raw``'s idx files (plain or
    ``.gz``), normalized by 0.1307 / 0.3081; without them, and with
    ``synthetic_fallback``, 6000 training or 1000 eval synthetic images."""
    root = Path(data_dir) / "MNIST" / "raw"
    prefix = "train" if training else "t10k"
    try:
        images = _read_idx(_find_idx(root, f"{prefix}-images-idx3-ubyte"))
        labels = _read_idx(_find_idx(root, f"{prefix}-labels-idx1-ubyte"))
        images = images[..., None]
    except (FileNotFoundError, OSError):
        if not synthetic_fallback:
            raise
        images, labels = _synthetic_classification(
            6000 if training else 1000, (28, 28, 1), 10, seed,
            split="train" if training else "eval")
    ds = ArrayDataset(images, labels, MNIST_MEAN, MNIST_STD)
    return DataLoader(ds, batch_size, shuffle and training, validation_split,
                      drop_last=training, seed=seed)


def ImageNet(data_dir: str, batch_size: int = 64, shuffle: bool = True,
             training: bool = True, size: int = 224,
             n_samples: Optional[int] = None, random_sample: bool = False,
             validation_split: float = 0.0, num_workers: int = 8,
             synthetic_fallback: bool = True, seed: int = 0,
             prefetch_depth: int = 2,
             native_decode: Optional[bool] = None):
    """ImageNet at ``size``² from ``<data_dir>/train`` (``training``) or
    ``<data_dir>/val``: an :class:`ImageFolderDataset` decoding each batch
    on ``num_workers`` threads, ``n_samples`` of its images (the first, or
    drawn at random), wrapped in ``prefetch(prefetch_depth)``.  With no such
    folder, and ``synthetic_fallback``, the seeded synthetic fallback of
    1000 classes (``n_samples`` images, else 2048 for training and 1024 for
    eval).  The training loader shuffles and augments (RandomResizedCrop
    and flip from a folder, pad-crop and flip on the fallback), and drops
    the last partial batch.  ref: data_loaders.py:61-89.
    """
    split_dir = Path(data_dir) / ("train" if training else "val")
    if split_dir.is_dir():
        paths, labels, _ = scan_image_folder(split_dir)
        paths = np.array(paths, dtype=object)
        if n_samples:
            idx = (np.random.default_rng(seed).choice(
                len(paths), n_samples, replace=False)
                if random_sample else np.arange(n_samples))
            paths, labels = paths[idx], labels[idx]
        ds = ImageFolderDataset(paths, labels, size, IMAGENET_MEAN,
                                IMAGENET_STD, train_augment=training,
                                num_workers=num_workers or 8,
                                native_decode=native_decode)
    else:
        if not synthetic_fallback:
            raise FileNotFoundError(split_dir)
        images, labels = _synthetic_classification(
            n_samples or (2048 if training else 1024), (size, size, 3),
            1000, seed, split="train" if training else "eval")
        ds = ArrayDataset(images, labels, IMAGENET_MEAN, IMAGENET_STD,
                          train_augment=training)
    loader = DataLoader(ds, batch_size, shuffle and training,
                        validation_split, drop_last=training, seed=seed)
    if isinstance(ds, ImageFolderDataset) and prefetch_depth:
        return loader.prefetch(prefetch_depth)
    return loader


def Synthetic(batch_size: int = 64, image_size: int = 224,
              num_classes: int = 1000, length: int = 1281167,
              materialized: int = 4096, training: bool = True,
              seed: int = 0, **_kw) -> DataLoader:
    """Random images of ``num_classes`` classes (ref: benchmark.py:35-54
    ``_MyDataset``): ``min(materialized, length)`` distinct images held in
    memory, shuffled when ``training``."""
    images, labels = _synthetic_classification(
        min(materialized, length), (image_size, image_size, 3), num_classes,
        seed)
    ds = ArrayDataset(images, labels, IMAGENET_MEAN, IMAGENET_STD)
    return DataLoader(ds, batch_size, shuffle=training, seed=seed)


DATALOADERS = {
    "Mnist": Mnist,
    "CIFAR10": CIFAR10,
    "CIFAR100": CIFAR100,
    "ImageNet": ImageNet,
    "Synthetic": Synthetic,
}


def get_dataloader(name: str, **kwargs):
    try:
        return DATALOADERS[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown dataloader {name!r}; known: "
            f"{sorted(DATALOADERS)}") from None
