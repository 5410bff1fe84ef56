"""Numpy datasets and batch loaders, on the host.

Counterpart of the ImageNet path of ``dlmc_quant_tpu/data/loaders.py``
(a copy: that module is numpy-only, but importing it would import the JAX
package).  With no ImageNet on disk, ``ImageNet`` falls back to seeded
synthetic data, array for array the JAX package's.  Batches are numpy
(N, H, W, C) float32 and int32 labels; the caller moves them to its device.

Not ported yet (ROADMAP Queue A item 14): the ImageNet folder reader and
its JPEG decode, the native C++ batch assembly (the numpy path here draws
the same randomness and gives the same arrays), MNIST, CIFAR and the
benchmark's ``Synthetic`` loader.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


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
    ``drop_last``.  ref: base/base_data_loader.py:7-64"""

    def __init__(self, dataset: ArrayDataset, batch_size: int = 128,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.dataset))
        rng = np.random.default_rng((self.seed, self._epoch))
        if self.shuffle:
            rng.shuffle(idx)
        for b in range(len(self)):
            batch_idx = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.dataset.get_batch(
                batch_idx, rng if self.dataset.train_augment else None)


def _synthetic_classification(n: int, image_size, num_classes: int,
                              seed: int = 0, split: str = "train"):
    """Learnable synthetic data: per-class mean patterns + noise (the JAX
    package's ``'easy'`` profile).

    The prototypes come from ``seed`` alone, so train and eval share them;
    labels and noise come from a stream of their own per split.
    """
    h, w, c = image_size
    rng = np.random.default_rng(seed)
    srng = np.random.default_rng((seed, 0 if split == "train" else 1))
    labels = srng.integers(0, num_classes, n)
    protos = rng.normal(0.5, 0.25, (num_classes, h, w, c)).astype(np.float32)
    images = protos[labels] + srng.normal(0, 0.25, (n, h, w, c))
    return np.clip(images, 0, 1).astype(np.float32), labels


def ImageNet(data_dir: str, batch_size: int = 64, shuffle: bool = True,
             training: bool = True, size: int = 224,
             n_samples: Optional[int] = None, random_sample: bool = False,
             synthetic_fallback: bool = True, seed: int = 0) -> DataLoader:
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
            "(ROADMAP Queue A item 14); without it the synthetic fallback "
            "runs")
    if not synthetic_fallback:
        raise FileNotFoundError(split_dir)
    images, labels = _synthetic_classification(
        n_samples or (2048 if training else 1024), (size, size, 3), 1000,
        seed, split="train" if training else "eval")
    ds = ArrayDataset(images, labels, IMAGENET_MEAN, IMAGENET_STD,
                      train_augment=training)
    return DataLoader(ds, batch_size, shuffle and training,
                      drop_last=training, seed=seed)


DATALOADERS = {"ImageNet": ImageNet}
_NOT_PORTED = ("Mnist", "CIFAR10", "CIFAR100", "Synthetic")


def get_dataloader(name: str, **kwargs) -> DataLoader:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataloader {name!r} is not ported yet (ROADMAP Queue A item 14)")
    try:
        return DATALOADERS[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown dataloader {name!r}; known: "
            f"{sorted(DATALOADERS)}") from None
