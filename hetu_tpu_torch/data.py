"""Datasets (a copy of ``hetu_tpu/data.py``, which the port may not
import; reference parity: python/hetu/data.py — MNIST/CIFAR10/CIFAR100
fetch+load helpers, one-hot conversion, augmentation).

This environment has no network egress, so each loader first looks for the
on-disk dataset (HETU_DATA_DIR or ./datasets) and otherwise falls back to a
deterministic synthetic sample with identical shapes/dtypes — sufficient
for framework and performance testing; swap in the real files for accuracy
work.
"""
from __future__ import annotations

import gzip
import os
import pickle

import numpy as np

__all__ = ["mnist", "digits", "cifar10", "cifar100", "normalize_cifar",
           "convert_to_one_hot", "data_augmentation", "synthetic"]


def _data_dir():
    return os.environ.get("HETU_DATA_DIR",
                          os.path.join(os.getcwd(), "datasets"))


def convert_to_one_hot(vals, max_val=0):
    if max_val == 0:
        max_val = int(vals.max()) + 1
    out = np.zeros((len(vals), max_val), dtype=np.float32)
    out[np.arange(len(vals)), vals.astype(np.int64)] = 1.0
    return out


def synthetic(n, x_shape, num_classes, seed=0, onehot=True):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, *x_shape).astype(np.float32)
    y = rng.randint(0, num_classes, size=n)
    # plant a learnable signal: class shifts the mean of a feature block
    flat = x.reshape(n, -1)
    block = max(1, flat.shape[1] // num_classes)
    for c in range(num_classes):
        flat[y == c, c * block:(c + 1) * block] += 0.5
    x = flat.reshape(n, *x_shape)
    if onehot:
        y = convert_to_one_hot(y, num_classes)
    return x, y.astype(np.float32)


def _warn_synthetic(name):
    """Synthesizing a stand-in must be LOUD: silent synthesis makes
    accuracy claims ambiguous. HETU_REQUIRE_REAL_DATA=1 turns it into an
    error for accuracy work."""
    import sys
    if os.environ.get("HETU_REQUIRE_REAL_DATA", "0") == "1":
        raise FileNotFoundError(
            f"{name}: real dataset files not found under {_data_dir()} "
            "and HETU_REQUIRE_REAL_DATA=1 — drop the files in (see "
            "hetu_tpu_torch/data.py loaders for accepted formats) or unset "
            "the flag")
    print(f"[hetu-data] {name}: real files not found under "
          f"{_data_dir()}; using a DETERMINISTIC SYNTHETIC stand-in "
          "(shapes/dtypes match; accuracies are not comparable to "
          "published numbers)", file=sys.stderr)


def _load_idx(path):
    """Read an MNIST IDX (ubyte) file, gzipped or not — the format the
    reference's loader downloads (reference data.py:5-44)."""
    import struct
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        if magic[0] != 0:
            raise ValueError(f"{path}: not an IDX file")
        if magic[1] != 0x08:
            raise ValueError(
                f"{path}: IDX dtype code 0x{magic[1]:02x} is not ubyte "
                "(0x08) — MNIST files are ubyte; refusing to reinterpret")
        ndim = magic[2]
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_idx(stem):
    for suffix in ("", ".gz"):
        p = os.path.join(_data_dir(), stem + suffix)
        if os.path.exists(p):
            return p
    return None


def mnist(dataset="mnist.pkl.gz", onehot=True):
    """Returns [(train_x, train_y), (valid_x, valid_y), (test_x, test_y)]
    with x flattened to 784 (reference data.py:5-44). Accepts either the
    pickled ``mnist.pkl.gz`` or the standard IDX files
    (``train-images-idx3-ubyte[.gz]`` etc.) in HETU_DATA_DIR; with
    neither present, synthesizes a stand-in LOUDLY (stderr, or an error
    under HETU_REQUIRE_REAL_DATA=1)."""
    path = os.path.join(_data_dir(), dataset)
    if os.path.exists(path):
        with gzip.open(path, "rb") as f:
            train_set, valid_set, test_set = pickle.load(f, encoding="latin1")

        def prep(split):
            x, y = split
            y = convert_to_one_hot(y, 10) if onehot else y
            return x.astype(np.float32), y
        return [prep(train_set), prep(valid_set), prep(test_set)]
    ti = _find_idx("train-images-idx3-ubyte")
    tl = _find_idx("train-labels-idx1-ubyte")
    vi = _find_idx("t10k-images-idx3-ubyte")
    vl = _find_idx("t10k-labels-idx1-ubyte")
    if ti and tl and vi and vl:
        tx = _load_idx(ti).reshape(-1, 784).astype(np.float32) / 255.0
        ty = _load_idx(tl)
        sx = _load_idx(vi).reshape(-1, 784).astype(np.float32) / 255.0
        sy = _load_idx(vl)
        n = max(1, len(tx) - len(tx) // 6)     # carve a validation split
        vx, vy = tx[n:], ty[n:]
        tx, ty = tx[:n], ty[:n]
        if onehot:
            ty, vy, sy = (convert_to_one_hot(a, 10) for a in (ty, vy, sy))
        return [(tx, ty), (vx, vy), (sx, sy)]
    _warn_synthetic("mnist")
    tx, ty = synthetic(10000, (784,), 10, seed=1, onehot=onehot)
    vx, vy = synthetic(2000, (784,), 10, seed=2, onehot=onehot)
    sx, sy = synthetic(2000, (784,), 10, seed=3, onehot=onehot)
    return [(tx, ty), (vx, vy), (sx, sy)]


def digits(onehot=True):
    """The checked-in REAL dataset: 1,797 8x8 handwritten digit images
    (UCI optical-recognition set, shipped at datasets/digits.npz so
    accuracy tests train on real data with zero network egress).  It is
    found in HETU_DATA_DIR or ./datasets, else beside this package.
    Returns [(train_x, train_y), (valid_x, valid_y),
    (test_x, test_y)] with x flattened to 64, mirroring :func:`mnist`'s
    split convention."""
    path = os.path.join(_data_dir(), "digits.npz")
    if not os.path.exists(path):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "datasets", "digits.npz")
    with np.load(path) as d:
        x, y = d["x"].astype(np.float32), d["y"]
    n1, n2 = 1437, 1617      # 80 / 10 / 10 split of the shuffled shard
    if onehot:
        y = convert_to_one_hot(y, 10)
    return [(x[:n1], y[:n1]), (x[n1:n2], y[n1:n2]), (x[n2:], y[n2:])]


def _cifar(directory, num_class, onehot):
    base = os.path.join(_data_dir(), directory)
    if os.path.isdir(base):
        xs, ys = [], []
        for name in sorted(os.listdir(base)):
            if "batch" not in name:
                continue
            with open(os.path.join(base, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], dtype=np.float32) / 255.0)
            key = b"labels" if b"labels" in d else b"fine_labels"
            ys.append(np.asarray(d[key]))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32)
        y = np.concatenate(ys)
        if onehot:
            y = convert_to_one_hot(y, num_class)
        n = len(x) * 5 // 6
        return (x[:n], y[:n]), (x[n:], y[n:])
    _warn_synthetic(directory)
    tx, ty = synthetic(10000, (3, 32, 32), num_class, seed=4, onehot=onehot)
    vx, vy = synthetic(2000, (3, 32, 32), num_class, seed=5, onehot=onehot)
    return (tx, ty), (vx, vy)


def cifar10(directory="CIFAR_10", onehot=True):
    (tx, ty), (vx, vy) = _cifar(directory, 10, onehot)
    return tx, ty, vx, vy


def cifar100(directory="CIFAR_100", onehot=True):
    (tx, ty), (vx, vy) = _cifar(directory, 100, onehot)
    return tx, ty, vx, vy


def normalize_cifar(num_class=10, onehot=True):
    """Channel-normalized CIFAR (reference data.py:153-181)."""
    if num_class == 10:
        tx, ty, vx, vy = cifar10(onehot=onehot)
    else:
        tx, ty, vx, vy = cifar100(onehot=onehot)
    mean = tx.mean(axis=(0, 2, 3), keepdims=True)
    std = tx.std(axis=(0, 2, 3), keepdims=True) + 1e-7
    tx = (tx - mean) / std
    vx = (vx - mean) / std
    return tx, ty, vx, vy


def data_augmentation(images, mode="train", flip=False, crop_shape=None,
                      whiten=False, noise=False, seed=0):
    """Random crop/flip/whiten/noise (reference data.py:225-295)."""
    rng = np.random.RandomState(seed)
    out = images
    if crop_shape is not None:
        n, c, h, w = out.shape
        ch, cw = crop_shape
        if mode == "train":
            oh = rng.randint(0, h - ch + 1, size=n)
            ow = rng.randint(0, w - cw + 1, size=n)
            out = np.stack([img[:, y:y + ch, x:x + cw]
                            for img, y, x in zip(out, oh, ow)])
        else:
            y, x = (h - ch) // 2, (w - cw) // 2
            out = out[:, :, y:y + ch, x:x + cw]
    if flip and mode == "train":
        mask = rng.rand(len(out)) < 0.5
        out[mask] = out[mask][..., ::-1]
    if whiten:
        mean = out.mean(axis=(1, 2, 3), keepdims=True)
        std = out.std(axis=(1, 2, 3), keepdims=True) + 1e-7
        out = (out - mean) / std
    if noise and mode == "train":
        out = out + rng.normal(0, 0.01, out.shape).astype(out.dtype)
    return out
