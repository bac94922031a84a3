"""PRVNet datasets, in numpy.

Counterpart of ``nerf_prv_tpu/prvnet/data.py``, copied (the module is numpy
and PIL only; the port keeps its own copy so that it imports nothing of the
JAX package): per-object directories holding the coverage images
``rgbaClip_<i>.png`` and an integer ``view_budget.txt`` label; K input views
chosen by ``IMG_PATTERN``; images center-cropped to 720 and scaled to [0, 1].
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .model import IMG_PATTERN

# Decoded-image cache: every epoch re-reads the same files, and a PNG
# decode costs more than keeping its cropped uint8 copy (720^2*3 = 1.5 MB
# per view).  Bounded by PRV_IMG_CACHE_MB (0 disables).
_CACHE_MB = float(os.environ.get("PRV_IMG_CACHE_MB", 24576))
_cache: dict = {}
_cache_bytes = 0
_cache_lock = threading.Lock()
_POOL = ThreadPoolExecutor(max_workers=int(os.environ.get("PRV_LOADER_THREADS", 8)))
# separate single-thread executor for batch prefetch: a fetch task waits on
# _POOL item decodes, so running it on _POOL itself could deadlock at small
# worker counts
_PREFETCH = ThreadPoolExecutor(max_workers=1)


def _load_u8(path: str, crop: Optional[int]) -> np.ndarray:
    """Cached decode -> RGB uint8, center-cropped."""
    global _cache_bytes
    mtime = os.path.getmtime(path)
    key = (path, crop, mtime)
    with _cache_lock:
        hit = _cache.get(key)
    if hit is not None:
        return hit
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"))
    if crop:
        img = center_crop(img, crop)
    img = np.ascontiguousarray(img)
    with _cache_lock:
        # re-check under the lock: two pool threads can race the same key,
        # and a double insert would count the bytes twice for one retained
        # array
        if key not in _cache:
            # a rewritten file supersedes its older-mtime entry; evict it
            # so re-rendered datasets don't pin dead bytes against the cap
            for k in [k for k in _cache if k[0] == path and k[1] == crop]:
                _cache_bytes -= _cache[k].nbytes
                del _cache[k]
            if _cache_bytes + img.nbytes <= _CACHE_MB * 2**20:
                _cache[key] = img
                _cache_bytes += img.nbytes
    return img


def center_crop(img: np.ndarray, size: int = 720) -> np.ndarray:
    """Center crop (pad if smaller), ≙ torchvision CenterCrop(720)."""
    h, w = img.shape[:2]
    if h < size or w < size:
        ph, pw = max(size - h, 0), max(size - w, 0)
        img = np.pad(
            img,
            ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)) + ((0, 0),) * (img.ndim - 2),
        )
        h, w = img.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return img[top : top + size, left : left + size]


def load_rgb(path: str, crop: Optional[int] = 720) -> np.ndarray:
    """RGB float32 [0,1]; RGBA flattened onto black like PIL convert('RGB')
    drops alpha (≙ Image.open(...).convert('RGB'), train_regression.py:232)."""
    return _load_u8(path, crop).astype(np.float32) / 255.0


def read_split(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


class PVBDataset:
    """K-view samples: (views (K,H,W,3), label int)."""

    def __init__(
        self,
        root: str,
        split_file: str,
        pattern: Sequence[int] = IMG_PATTERN[4],
        crop: int = 720,
    ):
        self.root = root
        self.names = read_split(split_file)
        self.pattern = list(pattern)
        self.crop = crop

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        d = os.path.join(self.root, self.names[i])
        views = np.stack(
            [load_rgb(os.path.join(d, f"rgbaClip_{j}.png"), self.crop) for j in self.pattern]
        )
        return views, _read_label(os.path.join(d, "view_budget.txt"))

    def item_u8(self, i: int) -> Tuple[np.ndarray, int]:
        """Undecoded-dtype variant for the device-resident path: uint8
        views (K,H,W,3) — normalization happens on device."""
        d = os.path.join(self.root, self.names[i])
        views = np.stack(
            [_load_u8(os.path.join(d, f"rgbaClip_{j}.png"), self.crop)
             for j in self.pattern]
        )
        return views, _read_label(os.path.join(d, "view_budget.txt"))

    def batches(
        self, batch_size: int, rng: Optional[np.random.Generator] = None, drop_last: bool = False
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        yield from _batched(self, batch_size, rng, drop_last)


class PVBPretrainDataset:
    """Every one of the 64 views as an independent sample
    (≙ pvbPretrainDataset, train_regression.py:101-167)."""

    def __init__(self, root: str, split_file: str, viewspace_size: int = 64, crop: int = 720):
        self.samples = []
        for name in read_split(split_file):
            for j in range(viewspace_size):
                self.samples.append((name, j))
        self.root = root
        self.crop = crop

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int):
        name, j = self.samples[i]
        d = os.path.join(self.root, name)
        img = load_rgb(os.path.join(d, f"rgbaClip_{j}.png"), self.crop)
        return img, _read_label(os.path.join(d, "view_budget.txt"))

    def item_u8(self, i: int):
        name, j = self.samples[i]
        d = os.path.join(self.root, name)
        img = _load_u8(os.path.join(d, f"rgbaClip_{j}.png"), self.crop)
        return img, _read_label(os.path.join(d, "view_budget.txt"))

    def batches(
        self, batch_size: int, rng: Optional[np.random.Generator] = None, drop_last: bool = False
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(imgs (B,H,W,3), labels (B,)) minibatches, shuffled when given rng."""
        yield from _batched(self, batch_size, rng, drop_last)


_label_cache: dict = {}


def _read_label(path: str) -> int:
    # mtime-keyed like the image cache: the pipeline rewrites
    # view_budget.txt when a dataset is rebuilt in the same process
    key = (path, os.path.getmtime(path))
    v = _label_cache.get(key)
    if v is None:
        v = _label_cache[key] = int(np.loadtxt(path))
    return v


def _batched(ds, batch_size, rng, drop_last):
    """Shared minibatch iterator: samples decode on the thread pool while
    the accelerator consumes the previous batch (one-batch prefetch)."""
    order = np.arange(len(ds))
    if rng is not None:
        rng.shuffle(order)
    starts = list(range(0, len(order), batch_size))

    def fetch(s):
        idx = order[s : s + batch_size]
        if drop_last and len(idx) < batch_size:
            return None
        items = list(_POOL.map(ds.__getitem__, idx))
        first, labels = zip(*items)
        return np.stack(first), np.asarray(labels, np.float32)

    pending = None
    for s in starts:
        nxt = _PREFETCH.submit(fetch, s)
        if pending is not None:
            b = pending.result()
            if b is not None:
                yield b
        pending = nxt
    if pending is not None:
        b = pending.result()
        if b is not None:
            yield b


def resident_arrays(ds) -> Tuple[np.ndarray, np.ndarray]:
    """Decode an entire split once (thread pool) into a uint8 image stack +
    float32 labels, for a device-resident trainer: the split crosses to the
    device once, as uint8 (4x smaller than float32), instead of every
    micro-batch's pixels every epoch."""
    items = list(_POOL.map(ds.item_u8, range(len(ds))))
    imgs = np.stack([v for v, _ in items])
    labels = np.asarray([l for _, l in items], np.float32)
    return imgs, labels
