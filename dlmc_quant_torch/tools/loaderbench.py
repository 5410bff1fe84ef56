"""How fast the streaming ImageFolder loader feeds a model, on this host.

Counterpart of ``tools/loaderbench.py``.  Writes a JPEG ImageFolder tree of
random RGB images at ImageNet-like sizes (500×375, 375×500, 256², 640×480),
then measures images/s through ``ImageFolderDataset`` +
``DataLoader.prefetch`` for the train transform (header read on the decode
threads, RandomResizedCrop, flip) and the eval transform (resize + centre
crop), at 4, 8 and 16 decode threads.  Host only: no card is used.

    python -m dlmc_quant_torch.tools.loaderbench [--images 600]
        [--batch 128] [--size 224] [--seconds 6]

Prints one JSON line: the host's CPU count, the decoder (libjpeg where
``data/native/jpegdec.cpp`` builds, else PIL), the batch assembly, and
``train_ips_w<n>`` / ``eval_ips_w<n>``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from dlmc_quant_torch.data import native
from dlmc_quant_torch.data.loaders import (DataLoader, ImageFolderDataset,
                                           scan_image_folder)

SIZES = ((500, 375), (375, 500), (256, 256), (640, 480))


def make_tree(root: Path, n_images: int, classes: int = 4, seed: int = 0,
              threads: int = 8):
    """``n_images`` random RGB JPEGs (quality 85) in ``classes`` class
    folders under ``root``, the sizes of ``SIZES`` in turn; PIL encodes."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for c in range(classes):
        (root / f"class_{c}").mkdir(parents=True, exist_ok=True)
    arrays = []
    for i in range(n_images):
        w, h = SIZES[i % len(SIZES)]
        arrays.append(rng.integers(0, 256, (h, w, 3), np.uint8))

    def save(i):
        Image.fromarray(arrays[i]).save(
            root / f"class_{i % classes}" / f"img_{i:05d}.jpg", quality=85)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(save, range(n_images)))


def measure(ds, batch: int, train: bool, seconds: float = 6.0,
            depth: int = 3) -> float:
    """Images/s through ``ds`` in a loader prefetched ``depth`` batches
    ahead, over ``seconds`` after a first batch that warms the pool."""
    def batches():
        epoch = 0
        while True:
            loader = DataLoader(ds, batch_size=batch, shuffle=train,
                                drop_last=True)
            loader.set_epoch(epoch)
            yield from loader.prefetch(depth)
            epoch += 1

    it = batches()
    next(it)
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        x, _ = next(it)
        n += x.shape[0]
    ips = n / (time.perf_counter() - t0)
    it.close()
    return ips


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=600)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    decode = native.jpeg_available()
    tmp = Path(tempfile.mkdtemp(prefix="loaderbench_"))
    try:
        make_tree(tmp, args.images)
        paths, labels, _ = scan_image_folder(tmp)
        out = {"images": args.images, "batch": args.batch,
               "cpu_count": os.cpu_count(),
               "decoder": "libjpeg" if decode else "PIL",
               "batch_assembly": "native" if native.available() else "numpy"}
        for workers in (4, 8, 16):
            for train in (True, False):
                ds = ImageFolderDataset(paths, labels, size=args.size,
                                        train_augment=train,
                                        num_workers=workers,
                                        native_decode=decode)
                key = f"{'train' if train else 'eval'}_ips_w{workers}"
                out[key] = measure(ds, args.batch, train, args.seconds)
        print(json.dumps(out))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
