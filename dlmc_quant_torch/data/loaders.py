"""Numpy datasets and batch loaders, on the host.

Counterpart of the ImageNet and CIFAR paths of
``dlmc_quant_tpu/data/loaders.py`` (a copy: that module is numpy-only, but
importing it would import the JAX package).  With no dataset on disk,
``ImageNet``, ``CIFAR10`` and ``CIFAR100`` fall back to seeded synthetic
data (the ``'easy'`` or ``'hard'`` profile), array for array the JAX
package's, and batch for batch: the same numpy draws.  Batches are numpy
(N, H, W, C) float32 and int32 labels; the caller moves them to its device.

``validation_split`` holds out a seeded share of the training set (the
same indices as the JAX package's), which ``split_validation()`` serves.

Not ported yet (ROADMAP Queue A, data left (item 10)): reading an ImageNet
folder or CIFAR's pickles, the native C++ batch assembly (the numpy path
here draws the same randomness and gives the same arrays), MNIST and the
benchmark's ``Synthetic`` loader.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
DATA_ITEM = "ROADMAP Queue A, data left (item 10)"


class ArrayDataset:
    """In-memory dataset: images (N,H,W,C) uint8/float32 + labels (N,).

    A batch is gathered, scaled by 1/255 if the images are 8-bit, and with
    ``train_augment`` pad-cropped and flipped, then normalized.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 mean=None, std=None, train_augment: bool = False,
                 pad: int = 4):
        assert len(images) == len(labels)
        self.images = images
        self.labels = np.asarray(labels, np.int32)
        self.mean = mean
        self.std = std
        self.train_augment = train_augment
        self.pad = pad
        self._scale255 = (images.dtype == np.uint8
                          or float(images[:16].max(initial=0.0)) > 2.0)

    def __len__(self):
        return len(self.images)

    def get_batch(self, idx: np.ndarray, rng: Optional[np.random.Generator]
                  ) -> Tuple[np.ndarray, np.ndarray]:
        x = self.images[idx].astype(np.float32)
        if self._scale255:
            x = x / 255.0
        if self.train_augment and rng is not None:
            n = len(idx)
            oy = rng.integers(0, 2 * self.pad + 1, n)
            ox = rng.integers(0, 2 * self.pad + 1, n)
            flip = rng.random(n) < 0.5
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

    def __init__(self, dataset: ArrayDataset, batch_size: int = 128,
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
    """The first ``n_samples``, or as many drawn at random."""
    if not n_samples or n_samples >= len(images):
        return images, labels
    if random_sample:
        idx = np.random.default_rng(seed).choice(len(images), n_samples,
                                                 replace=False)
    else:
        idx = np.arange(n_samples)
    return images[idx], labels[idx]


def ImageNet(data_dir: str, batch_size: int = 64, shuffle: bool = True,
             training: bool = True, size: int = 224,
             n_samples: Optional[int] = None, random_sample: bool = False,
             validation_split: float = 0.0, synthetic_fallback: bool = True,
             seed: int = 0) -> DataLoader:
    """ImageNet at ``size``², or with no ``<data_dir>/train|val`` folder
    the seeded synthetic fallback of 1000 classes (``n_samples`` images,
    else 2048 for training and 1024 for eval).  The training loader
    shuffles, pad-crops and flips, and drops the last partial batch.

    ``random_sample`` would pick the ``n_samples`` images of a real folder;
    the fallback generates exactly ``n_samples``, as in the JAX package.
    """
    split_dir = Path(data_dir) / ("train" if training else "val")
    if split_dir.is_dir():
        raise NotImplementedError(
            f"{split_dir}: reading an ImageNet folder is not ported yet "
            f"({DATA_ITEM}); without it the synthetic fallback runs")
    if not synthetic_fallback:
        raise FileNotFoundError(split_dir)
    images, labels = _synthetic_classification(
        n_samples or (2048 if training else 1024), (size, size, 3), 1000,
        seed, split="train" if training else "eval")
    ds = ArrayDataset(images, labels, IMAGENET_MEAN, IMAGENET_STD,
                      train_augment=training)
    return DataLoader(ds, batch_size, shuffle and training, validation_split,
                      drop_last=training, seed=seed)


def CIFAR10(data_dir: str = "data", batch_size: int = 128,
            shuffle: bool = True, validation_split: float = 0.0,
            training: bool = True, n_samples: Optional[int] = None,
            random_sample: bool = False, synthetic_fallback: bool = True,
            seed: int = 0, synthetic_profile: str = "easy",
            _n_classes: int = 10) -> DataLoader:
    """CIFAR-10 (``_n_classes=100``: CIFAR-100) at 32², or with no
    ``<data_dir>/cifar-10-batches-py`` folder the seeded synthetic fallback
    (10000 training or 2000 eval images), then ``n_samples`` of them.  The
    training loader shuffles, pad-crops and flips, and drops the last
    partial batch."""
    folder = Path(data_dir) / ("cifar-10-batches-py" if _n_classes == 10
                               else "cifar-100-python")
    if folder.is_dir():
        raise NotImplementedError(
            f"{folder}: reading CIFAR's pickles is not ported yet "
            f"({DATA_ITEM}); without them the synthetic fallback runs")
    if not synthetic_fallback:
        raise FileNotFoundError(folder)
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


DATALOADERS = {"ImageNet": ImageNet, "CIFAR10": CIFAR10,
               "CIFAR100": CIFAR100}
_NOT_PORTED = ("Mnist", "Synthetic")


def get_dataloader(name: str, **kwargs) -> DataLoader:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataloader {name!r} is not ported yet ({DATA_ITEM})")
    try:
        return DATALOADERS[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown dataloader {name!r}; known: "
            f"{sorted(DATALOADERS)}") from None
