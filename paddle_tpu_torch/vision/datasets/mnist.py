"""MNIST — twin of ``paddle_tpu/vision/datasets/mnist.py``: the idx-file
reader and, where no file is given or the path does not exist, the same
deterministic synthetic stand-in (numpy only: 2048 train / 512 test
images, seeds 42 and 7), so both packages see the same arrays.  Nothing
is downloaded and nothing outside the given paths is read.  Items are
``(image [1, 28, 28] float32 in [0, 1], label [1] int64)``; batch them
with ``io.DataLoader`` (or ``batch``)."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io.dataset import Dataset

__all__ = ["MNIST"]


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _magic, _n = struct.unpack(">II", f.read(8))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.astype(np.int64)


def synthetic_mnist(mode="train"):
    """The stand-in set of paddle_tpu's MNIST: a class-dependent bright
    band plus uniform noise, so a model can fit it."""
    n = 2048 if mode == "train" else 512
    rng = np.random.RandomState(42 if mode == "train" else 7)
    labels = rng.randint(0, 10, n).astype(np.int64)
    images = np.zeros((n, 28, 28), np.uint8)
    for i, label in enumerate(labels):
        images[i, 2 + label * 2: 8 + label * 2, 4:24] = 200
        images[i] += rng.randint(0, 30, (28, 28)).astype(np.uint8)
    return images, labels


class MNIST(Dataset):
    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode.lower()
        self.transform = transform
        if image_path and os.path.exists(image_path):
            self.images = _read_idx_images(image_path)
            self.labels = _read_idx_labels(label_path)
            self.synthetic = False
        else:
            self.images, self.labels = synthetic_mnist(self.mode)
            self.synthetic = True

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32)[None] / 255.0
        return img, np.asarray([label], dtype=np.int64)

    def __len__(self):
        return len(self.images)

    def batch(self, start: int, size: int):
        """Images ``[size, 1, 28, 28]`` float32 and labels ``[size, 1]``
        int64 of items ``start .. start + size - 1``, in order."""
        imgs = self.images[start:start + size].astype(np.float32)
        return (imgs[:, None] / 255.0,
                self.labels[start:start + size, None].astype(np.int64))
