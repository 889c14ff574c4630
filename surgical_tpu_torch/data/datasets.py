"""Host-side dataset layer: frame loading, clip sampling, batched prefetch.

Port of ``surgical_tpu/data/datasets.py``. The host decodes and resizes
into the compact wire format (uint8 images, uint8 single-channel segmaps,
fp16 flow); all float math (normalize, augment) runs on the device
(``data/transforms.py``). A thread-pool prefetcher replaces DataLoader
workers.

- ``clip_start_indices``: the reference's get_useful_start_idx
- ``ClipSampler``: clip starts expanded into a flat frame-index list
- ``load_image`` / ``load_flow``: PIL decode (+ resize), flow .npy
- ``DiskCache``: per-frame decoded-array cache
- ``ClipDataset``: img + segmap + flow + labels over an index split,
  decoded with PIL (the JAX package's native C++ decoder is not ported)
- ``prefetch_batches``: decode ``depth`` batches ahead of the consumer
- ``FrameCache``: packed memmap cache with the same ``frames`` contract
- ``RankSlice``: a source read only in this rank's slice of each batch
  (data-parallel extraction)
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def clip_start_indices(sequence_length: int, lengths: Sequence[int]) -> list[int]:
    """Valid clip start indices that never cross a video boundary
    (reference get_useful_start_idx, data_process.py:307-314)."""
    out = []
    count = 0
    for L in lengths:
        out.extend(range(count, count + int(L) + 1 - sequence_length))
        count += int(L)
    return out


@dataclass
class ClipSampler:
    """Expands clip starts into a flat frame-index list (reference
    SeqSampler + the trainers' shuffle-starts-then-expand pattern,
    train_evp.py:448-460)."""

    sequence_length: int
    starts: Sequence[int]
    seed: int = 0

    def indices(self, epoch: int | None = None, shuffle: bool = False) -> np.ndarray:
        starts = np.asarray(self.starts)
        if shuffle:
            # (seed, epoch) entropy pair: deterministic, distinct per epoch,
            # independent of any global RNG state
            starts = np.random.default_rng([self.seed, epoch or 0]).permutation(starts)
        return (starts[:, None] + np.arange(self.sequence_length)[None, :]).reshape(-1)


def load_image(path: str, mode: str = "RGB", size: int | None = None) -> np.ndarray:
    """PIL decode + convert (+ optional bilinear resize); uint8 HWC. Errors
    are logged and re-raised (reference pil_loader, data_process.py:34-49)."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            im = im.convert(mode)
            if size is not None:
                im = im.resize((size, size), Image.BILINEAR)
            arr = np.asarray(im)
    except Exception:
        logger.exception("failed to load %s", path)
        raise
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def load_flow(
    img_path: str,
    size: int,
    flow_root_sub: tuple[str, str] = ("cutMargin", "raft_flow_npy"),
) -> np.ndarray:
    """The frame's flow .npy (path substitution cutMargin -> raft_flow_npy,
    data_process.py:422), resized with displacement rescale (:433-444), zero
    flow when missing (:424-429). fp16 [size, size, 2]."""
    flow_path = img_path.replace(*flow_root_sub).replace(".jpg", ".npy")
    if not os.path.exists(flow_path):
        return np.zeros((size, size, 2), dtype=np.float16)
    flow = np.load(flow_path).astype(np.float32)
    H, W = flow.shape[:2]
    if (H, W) != (size, size):
        from PIL import Image

        u = np.asarray(Image.fromarray(flow[..., 0]).resize((size, size), Image.BILINEAR))
        v = np.asarray(Image.fromarray(flow[..., 1]).resize((size, size), Image.BILINEAR))
        flow = np.stack([u * size / W, v * size / H], axis=-1)
    return flow.astype(np.float16)


class DiskCache:
    """Optional decoded-array cache (reference CholecSegmapDataset1,
    data_process.py:327-393, caching compact uint8 arrays)."""

    def __init__(self, directory: str | None):
        self.directory = directory
        if directory:
            os.makedirs(directory, exist_ok=True)

    def get_or(self, key: str, fn):
        if not self.directory:
            return fn()
        path = os.path.join(self.directory, key.replace("/", "_") + ".npy")
        if os.path.exists(path):
            return np.load(path)
        arr = fn()
        tmp = path + ".tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, path)
        return arr


@dataclass
class ClipDataset:
    """Frame-level dataset over an index split, in the wire format:
    (img_u8 [S, r, r, 3], seg_u8 [S, r, r, 1], flow_f16 [S, r, r, 2] or None,
    phase [S], ant [S, 7]) with r = ``resize``.

    noise_segmap=True is the random-noise ablation (data_process.py:498-521);
    with_flow=False is CholecSegmapDataset; ant_cols selects the anticipation
    label columns (Cholec80 8:15, M2CAI16 1:9).
    """

    paths: Sequence[str]
    labels: np.ndarray  # [N, 15]
    resize: int = 250
    segmap_sub: tuple[str, str] = ("cutMargin", "ss_Bimasks_pos_ep10")
    with_flow: bool = True
    noise_segmap: bool = False
    ant_cols: tuple[int, int] = (8, 15)
    cache: DiskCache | None = None

    def __len__(self) -> int:
        return len(self.paths)

    def _load_img(self, path: str) -> np.ndarray:
        fn = lambda: load_image(path, "RGB", self.resize)
        return self.cache.get_or("img_" + path, fn) if self.cache else fn()

    def _load_seg(self, path: str) -> np.ndarray:
        if self.noise_segmap:
            rng = np.random.default_rng(zlib.crc32(path.encode()))
            return rng.integers(0, 255, (self.resize, self.resize, 1), dtype=np.uint8)
        seg_path = path.replace(*self.segmap_sub).replace(".jpg", ".png")
        if not os.path.exists(seg_path):
            seg_path = path.replace(*self.segmap_sub)
        fn = lambda: load_image(seg_path, "L", self.resize)
        return self.cache.get_or("seg_" + seg_path, fn) if self.cache else fn()

    def frames(self, indices: Sequence[int]):
        paths = [self.paths[i] for i in indices]
        imgs = np.stack([self._load_img(p) for p in paths])
        segs = np.stack([self._load_seg(p) for p in paths])
        flow = (np.stack([load_flow(p, self.resize) for p in paths])
                if self.with_flow else None)
        a0, a1 = self.ant_cols
        idx = np.asarray(indices)
        phase = self.labels[idx, 0].astype(np.int32)
        ant = self.labels[idx, a0:a1].astype(np.float32)
        return imgs, segs, flow, phase, ant


def prefetch_batches(
    dataset,
    indices: np.ndarray,
    batch_size: int,
    num_workers: int = 8,
    depth: int = 4,
) -> Iterator[tuple]:
    """Thread-pool prefetcher over ``dataset.frames``: decodes ``depth``
    batches ahead of the consumer (train_evp.py:346-360)."""
    chunks = [indices[i:i + batch_size] for i in range(0, len(indices), batch_size)]
    depth = max(1, min(depth, len(chunks)))
    pool = ThreadPoolExecutor(max_workers=num_workers)
    try:
        futures = [pool.submit(dataset.frames, c) for c in chunks[:depth]]
        next_submit = depth
        for i in range(len(chunks)):
            yield futures[i % depth].result()
            if next_submit < len(chunks):
                futures[i % depth] = pool.submit(dataset.frames, chunks[next_submit])
                next_submit += 1
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


class FrameCache:
    """Packed pre-decoded frame cache: one contiguous memmap per modality
    (uint8 images and segmaps, fp16 flow) plus the label table, so batches
    are read at page-cache bandwidth instead of decode speed. Decode cost is
    paid once (``build``). Serves the ``frames(indices)`` contract of
    ``ClipDataset``, so ``prefetch_batches`` takes it as a drop-in source.
    """

    MANIFEST = "manifest.json"
    PROGRESS = "progress.json"

    def __init__(self, directory: str):
        with open(os.path.join(directory, self.MANIFEST)) as f:
            self.meta = json.load(f)
        self.directory = directory
        mm = lambda name: np.load(os.path.join(directory, name), mmap_mode="r")
        self.imgs = mm("img.npy")
        self.segs = mm("seg.npy")
        self.flow = mm("flow.npy") if self.meta["with_flow"] else None
        self.labels = np.load(os.path.join(directory, "labels.npy"))
        self.ant_cols = tuple(self.meta["ant_cols"])

    def __len__(self) -> int:
        return self.imgs.shape[0]

    def frames(self, indices: Sequence[int]):
        idx = np.asarray(indices)
        a0, a1 = self.ant_cols
        return (
            np.asarray(self.imgs[idx]),
            np.asarray(self.segs[idx]),
            np.asarray(self.flow[idx]) if self.flow is not None else None,
            self.labels[idx, 0].astype(np.int32),
            self.labels[idx, a0:a1].astype(np.float32),
        )

    @classmethod
    def exists(cls, directory: str) -> bool:
        return os.path.exists(os.path.join(directory, cls.MANIFEST))

    @classmethod
    def build(cls, ds, directory: str, batch_size: int = 256,
              log_every: int = 20) -> "FrameCache":
        """Decode the whole dataset (any ``frames`` source with ``resize``,
        ``with_flow``, ``labels`` and ``ant_cols``) once into packed memmaps.
        Resumable: a progress marker records the next frame index."""
        from numpy.lib.format import open_memmap

        if cls.exists(directory):
            return cls(directory)
        os.makedirs(directory, exist_ok=True)
        n, r = len(ds), ds.resize
        prog_path = os.path.join(directory, cls.PROGRESS)
        done = 0
        if os.path.exists(prog_path):
            with open(prog_path) as f:
                done = json.load(f)["done"]
        mode = "r+" if done else "w+"
        arr = lambda name, shape, dt: open_memmap(
            os.path.join(directory, name), mode=mode, dtype=dt, shape=shape)
        imgs = arr("img.npy", (n, r, r, 3), np.uint8)
        segs = arr("seg.npy", (n, r, r, 1), np.uint8)
        flow = arr("flow.npy", (n, r, r, 2), np.float16) if ds.with_flow else None
        for b, start in enumerate(range(done, n, batch_size)):
            idx = np.arange(start, min(start + batch_size, n))
            im, sg, fl, _p, _a = ds.frames(idx)
            imgs[idx] = im
            segs[idx] = sg
            if flow is not None:
                flow[idx] = fl
            with open(prog_path + ".tmp", "w") as f:
                json.dump({"done": int(idx[-1]) + 1}, f)
            os.replace(prog_path + ".tmp", prog_path)
            if b % log_every == 0:
                logger.info("frame cache %s: %d/%d", directory, idx[-1] + 1, n)
        imgs.flush()
        segs.flush()
        if flow is not None:
            flow.flush()
        np.save(os.path.join(directory, "labels.npy"), np.asarray(ds.labels))
        manifest = {"frames": n, "resize": r, "with_flow": ds.with_flow,
                    "ant_cols": list(ds.ant_cols), "version": 1}
        with open(os.path.join(directory, cls.MANIFEST + ".tmp"), "w") as f:
            json.dump(manifest, f)
        os.replace(os.path.join(directory, cls.MANIFEST + ".tmp"),
                   os.path.join(directory, cls.MANIFEST))
        os.remove(prog_path)
        return cls(directory)


class RankSlice:
    """A ``frames`` source for data-parallel extraction: of each batch of at
    most ``batch_size`` indices (``prefetch_batches``' chunks) it reads or
    decodes only the frames in this rank's slice of the batch padded to
    ``batch_size`` (rank r of w: positions [r b/w, (r+1) b/w)), and returns
    the batch at its full length with zeros elsewhere. Every rank iterates
    the same batches, and ``make_raw_feature_fn`` over the group keeps each
    rank's slice; the labels are read whole. ``batch_size`` must divide over
    the ranks."""

    def __init__(self, source, batch_size: int, rank: int, world: int):
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} does not divide over {world} ranks")
        self.source, self.world = source, world
        per = batch_size // world
        self.lo, self.hi = rank * per, (rank + 1) * per

    def __len__(self) -> int:
        return len(self.source)

    def frames(self, indices: Sequence[int]):
        idx = np.asarray(indices)
        if self.world == 1:
            return self.source.frames(idx)
        mine = idx[self.lo:self.hi]
        # a rank whose slice lies wholly in the padding reads one frame for
        # the shapes and dtypes
        imgs, segs, flow, _p, _a = self.source.frames(mine if len(mine) else idx[:1])
        out = []
        for a in (imgs, segs, flow):
            if a is None:
                out.append(None)
                continue
            full = np.zeros((len(idx), *a.shape[1:]), dtype=a.dtype)
            full[self.lo:self.lo + len(mine)] = a[:len(mine)]
            out.append(full)
        labels, (a0, a1) = self.source.labels, self.source.ant_cols
        return (*out, labels[idx, 0].astype(np.int32), labels[idx, a0:a1].astype(np.float32))
