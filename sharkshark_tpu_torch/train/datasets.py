"""Training and test datasets and the BD degradation for the VSR tree
(counterpart of the JAX package's train/datasets.py; reference data/
{base,paired_folder,paired_lmdb,unpaired_lmdb}_dataset.py and
__init__.py:10-115).

- PairedFolderDataset: gt/lr sequence folders as NTHWC arrays;
- PairedFolderTrainDataset: random temporal window, synchronised random
  crop and flips over the same folders (the repo's own addition);
- PairedLMDBDataset / UnpairedLMDBDataset: Vimeo-style LMDBs with
  meta_info.pkl keys `idx_HxW_frm`, random crops, flips/transpose and
  the moving-first-frame trick; they need the optional `lmdb` package,
  imported when such a dataset is made;
- create_dataloader: a torch DataLoader over the numpy samples, with an
  optional torch.Generator for the shuffle;
- gaussian_downsample_kernel / prepare_data: the BD degradation, a
  13x13 Gaussian depthwise conv with stride `scale` on the batch's
  device, and the GT's border cut off (reference data/__init__.py:
  73-115).

Samples are numpy, channel-last; the crops and flips draw from a
`random.Random(seed)` exactly as the JAX package's datasets do, so one
seed gives both packages the same crops.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import random
from typing import Any

import numpy as np
import torch

from ..ops import conv2d
from ..utils import require_module

__all__ = [
    "PairedFolderDataset",
    "PairedFolderTrainDataset",
    "PairedLMDBDataset",
    "UnpairedLMDBDataset",
    "create_dataloader",
    "gaussian_downsample_kernel",
    "prepare_data",
]


def retrieve_files(directory: str) -> list[str]:
    exts = (".png", ".jpg", ".jpeg", ".bmp")
    return sorted(osp.join(directory, f) for f in os.listdir(directory) if f.lower().endswith(exts))


def _imread_rgb(path: str) -> np.ndarray:
    import cv2

    return cv2.imread(path)[..., ::-1]


class PairedFolderDataset:
    """gt/lr paired sequence folders (reference paired_folder_dataset.py).
    Returns dicts: gt (T,H,W,C) uint8, lr (T,h,w,C) float32, seq_idx."""

    def __init__(self, gt_seq_dir: str, lr_seq_dir: str, filter_file: str | None = None):
        self.gt_seq_dir = gt_seq_dir
        self.lr_seq_dir = lr_seq_dir
        keys = set(os.listdir(gt_seq_dir)) & set(os.listdir(lr_seq_dir))
        if filter_file:
            with open(filter_file) as f:
                keys &= {line.strip() for line in f}
        self.keys = sorted(keys)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, item: int) -> dict[str, Any]:
        key = self.keys[item]
        gt = np.stack([_imread_rgb(p) for p in retrieve_files(osp.join(self.gt_seq_dir, key))])
        lr = np.stack([
            _imread_rgb(p).astype(np.float32) / 255.0
            for p in retrieve_files(osp.join(self.lr_seq_dir, key))
        ])
        return {"gt": gt, "lr": lr, "seq_idx": key}


class _LMDBBase:
    """Vimeo-style LMDB: meta_info.pkl with 'keys' like 'idx_HxW_frm'
    (reference base_dataset.py:52-77, paired_lmdb_dataset.py:13-167)."""

    def __init__(self, seq_dir: str):
        lmdb = require_module("lmdb", "The LMDB datasets need the lmdb package; use a Folder dataset without it.")
        self.seq_dir = seq_dir
        with open(osp.join(seq_dir, "meta_info.pkl"), "rb") as f:
            self.meta = pickle.load(f)
        self.keys = self.meta["keys"]
        self.env = lmdb.open(seq_dir, readonly=True, lock=False, readahead=False, meminit=False)

    def parse_lmdb_key(self, key: str) -> tuple[int, tuple[int, int], int]:
        idx, hw, frm = key.split("_")
        h, w = map(int, hw.split("x"))
        return int(idx), (h, w), int(frm)

    def read_lmdb_frame(self, key: str, size: tuple[int, int, int]) -> np.ndarray:
        with self.env.begin(write=False) as txn:
            buf = txn.get(key.encode("ascii"))
        if buf is None:
            raise KeyError(key)
        return np.frombuffer(buf, np.uint8).reshape(size)


def _augment_clip(frames: list[np.ndarray], rng: random.Random) -> list[np.ndarray]:
    """Random flips + transpose (reference paired_lmdb_dataset augment)."""
    if rng.random() < 0.5:
        frames = [f[::-1] for f in frames]
    if rng.random() < 0.5:
        frames = [f[:, ::-1] for f in frames]
    if rng.random() < 0.5:
        frames = [f.transpose(1, 0, 2) for f in frames]
    return [np.ascontiguousarray(f) for f in frames]


class PairedLMDBDataset(_LMDBBase):
    """BI degradation training set: paired gt/lr LMDBs with synchronised
    random crops + moving-first-frame augmentation."""

    def __init__(
        self,
        gt_seq_dir: str,
        lr_seq_dir: str,
        scale: int = 4,
        crop_size: int = 128,
        tempo_extent: int = 10,
        moving_first_frame: bool = False,
        moving_factor: float = 1.0,
        seed: int | None = None,
    ):
        super().__init__(gt_seq_dir)
        self.lr = _LMDBBase(lr_seq_dir)
        self.scale = scale
        self.crop_size = crop_size
        self.tempo_extent = tempo_extent
        self.moving_first_frame = moving_first_frame
        self.moving_factor = moving_factor
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, item: int) -> dict[str, Any]:
        key = self.keys[item]
        idx, (gh, gw), frm = self.parse_lmdb_key(key)
        s = self.scale
        lh, lw = gh // s, gw // s
        cs = self.crop_size
        lcs = cs // s

        gt_frames, lr_frames = [], []
        if self.moving_first_frame and self.rng.random() < self.moving_factor:
            # synthesise motion by panning a random window over frame 0
            gt0 = self.read_lmdb_frame(key, (gh, gw, 3))
            lr0 = self.lr.read_lmdb_frame(self.lr.keys[item], (lh, lw, 3))
            max_dy = (gh - cs) // s
            max_dx = (gw - cs) // s
            y = self.rng.randint(0, max(max_dy, 0))
            x = self.rng.randint(0, max(max_dx, 0))
            vy = self.rng.randint(-2, 2)
            vx = self.rng.randint(-2, 2)
            for t in range(self.tempo_extent):
                yy = int(np.clip(y + vy * t, 0, max(max_dy, 0)))
                xx = int(np.clip(x + vx * t, 0, max(max_dx, 0)))
                gt_frames.append(gt0[yy * s : yy * s + cs, xx * s : xx * s + cs])
                lr_frames.append(lr0[yy : yy + lcs, xx : xx + lcs])
        else:
            y = self.rng.randint(0, max((gh - cs) // s, 0))
            x = self.rng.randint(0, max((gw - cs) // s, 0))
            start = self.rng.randint(0, max(frm - self.tempo_extent, 0))
            for t in range(self.tempo_extent):
                ti = min(start + t, frm - 1)
                try:
                    gt = self.read_lmdb_frame(f"{idx}_{gh}x{gw}_{frm}_{ti:04d}", (gh, gw, 3))
                    lr = self.lr.read_lmdb_frame(f"{idx}_{lh}x{lw}_{frm}_{ti:04d}", (lh, lw, 3))
                except KeyError:
                    # one blob per sequence
                    gt = self.read_lmdb_frame(key, (gh, gw, 3))
                    lr = self.lr.read_lmdb_frame(self.lr.keys[item], (lh, lw, 3))
                gt_frames.append(gt[y * s : y * s + cs, x * s : x * s + cs])
                lr_frames.append(lr[y : y + lcs, x : x + lcs])

        both = _augment_clip(gt_frames + lr_frames, self.rng)
        gt_frames, lr_frames = both[: len(gt_frames)], both[len(gt_frames):]
        return {
            "gt": np.stack(gt_frames).astype(np.float32) / 255.0,
            "lr": np.stack(lr_frames).astype(np.float32) / 255.0,
        }


class UnpairedLMDBDataset(_LMDBBase):
    """BD degradation training set: a gt-only LMDB; lr is made on the
    device by prepare_data (reference unpaired_lmdb_dataset.py)."""

    def __init__(
        self,
        gt_seq_dir: str,
        crop_size: int = 160,
        tempo_extent: int = 10,
        moving_first_frame: bool = False,
        moving_factor: float = 1.0,
        seed: int | None = None,
    ):
        super().__init__(gt_seq_dir)
        self.crop_size = crop_size
        self.tempo_extent = tempo_extent
        self.moving_first_frame = moving_first_frame
        self.moving_factor = moving_factor
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, item: int) -> dict[str, Any]:
        key = self.keys[item]
        idx, (gh, gw), frm = self.parse_lmdb_key(key)
        cs = self.crop_size
        frames = []
        y = self.rng.randint(0, max(gh - cs, 0))
        x = self.rng.randint(0, max(gw - cs, 0))
        start = self.rng.randint(0, max(frm - self.tempo_extent, 0))
        for t in range(self.tempo_extent):
            ti = min(start + t, frm - 1)
            try:
                f = self.read_lmdb_frame(f"{idx}_{gh}x{gw}_{frm}_{ti:04d}", (gh, gw, 3))
            except KeyError:
                f = self.read_lmdb_frame(key, (gh, gw, 3))
            frames.append(f[y : y + cs, x : x + cs])
        frames = _augment_clip(frames, self.rng)
        return {"gt": np.stack(frames).astype(np.float32) / 255.0}


class PairedFolderTrainDataset:
    """Training over paired gt/lr folders: random temporal window +
    synchronised random crop + flip augmentation (the reference trains
    from LMDBs only; this runs on plain image-sequence folders)."""

    def __init__(
        self,
        gt_seq_dir: str,
        lr_seq_dir: str,
        scale: int = 4,
        crop_size: int = 128,
        tempo_extent: int = 10,
        seed: int | None = None,
    ):
        self.inner = PairedFolderDataset(gt_seq_dir, lr_seq_dir)
        self.scale = scale
        self.crop_size = crop_size
        self.tempo_extent = tempo_extent
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.inner)

    def __getitem__(self, item: int) -> dict[str, Any]:
        s = self.scale
        sample = self.inner[item]
        gt, lr = sample["gt"].astype(np.float32) / 255.0, sample["lr"]
        t_total = gt.shape[0]
        te = min(self.tempo_extent, t_total)
        start = self.rng.randint(0, t_total - te)
        gt, lr = gt[start : start + te], lr[start : start + te]
        lcs = min(self.crop_size // s, lr.shape[1], lr.shape[2])
        y = self.rng.randint(0, lr.shape[1] - lcs)
        x = self.rng.randint(0, lr.shape[2] - lcs)
        gt = gt[:, y * s : (y + lcs) * s, x * s : (x + lcs) * s]
        lr = lr[:, y : y + lcs, x : x + lcs]
        both = _augment_clip(list(gt) + list(lr), self.rng)
        return {"gt": np.stack(both[:te]), "lr": np.stack(both[te:])}


def _collate(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


def create_dataloader(dataset, batch_size: int = 1, shuffle: bool = True, num_workers: int = 0,
                      generator: torch.Generator | None = None):
    """A torch DataLoader of numpy batches; `generator` seeds the shuffle."""
    import torch.utils.data as tud

    return tud.DataLoader(dataset, batch_size=batch_size, shuffle=shuffle, num_workers=num_workers,
                          collate_fn=_collate, generator=generator)


def gaussian_downsample_kernel(sigma: float = 1.5, ksize: int | None = None) -> np.ndarray:
    """BD degradation kernel (reference data_utils.create_kernel): a 2-D
    Gaussian of shape (k, k, 1, 1) for a depthwise strided conv."""
    if ksize is None:
        ksize = 2 * int(sigma * 3.0) + 1
    ax = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    g = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(g, g)
    k /= k.sum()
    return k.astype(np.float32).reshape(ksize, ksize, 1, 1)


def prepare_data(gt_with_border: torch.Tensor, kernel, scale: int = 4,
                 sigma: float = 1.5) -> dict[str, torch.Tensor]:
    """BD degradation on gt's device (reference data/__init__.py:85-112):
    lr = the stride-`scale` Gaussian conv of gt; gt loses the border.
    gt_with_border: (N, T, H, W, C) float in [0,1]; kernel: (k, k, 1, 1),
    numpy or a tensor (one already on gt's device is not copied)."""
    n, t, gh, gw, c = gt_with_border.shape
    border = int(sigma * 3.0)
    lh, lw = (gh - 2 * border) // scale, (gw - 2 * border) // scale

    x = gt_with_border.reshape(n * t, gh, gw, c)
    k = torch.as_tensor(kernel, device=x.device, dtype=x.dtype).repeat(1, 1, 1, c)  # depthwise
    lr = conv2d(x, k, stride=scale, padding=0, groups=c)
    lr = lr[:, :lh, :lw].reshape(n, t, lh, lw, c)

    gt = x[:, border : border + scale * lh, border : border + scale * lw]
    return {"gt": gt.reshape(n, t, scale * lh, scale * lw, c), "lr": lr}
