"""Derive a paired GT/LR training dataset from a folder of still images
(a copy of the JAX package's tools/make_derived_dataset.py).

Random GT crops of the stills become T-frame "sequences" with a
synthetic pan (the crop window slides a few pixels a frame, so the
temporal models see real motion), LR = the bicubic 1/s downscale (the BI
degradation).  The layout is what train/datasets.py reads:
<out>/{train,val}/{GT,LR}/<seq>/<frame>.png, and with --noisy-sigma also
<out>/val/noisy/<seq>/ (GT + seeded Gaussian noise) for denoise tests.
`write_stills` makes seeded textured stills for a run that has no
photographs.

    python -m sharkshark_tpu_torch.tools.make_derived_dataset --src DIR \\
        --out OUT --holdout a.png --seqs 200 --tempo 4 --crop 256 --scale 4
"""

from __future__ import annotations

import argparse
import glob
import os
import random

import numpy as np

__all__ = ["write_stills", "main"]


def load_rgb(path: str) -> np.ndarray:
    from PIL import Image

    im = Image.open(path)
    if im.mode != "RGB":
        im = im.convert("RGB")
    return np.asarray(im)


def save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def lr_of(gt: np.ndarray, scale: int) -> np.ndarray:
    import cv2

    h, w = gt.shape[:2]
    return cv2.resize(gt, (w // scale, h // scale), interpolation=cv2.INTER_CUBIC)


def textured_still(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """An (h, w, 3) uint8 image of oriented sinusoids at several scales
    under flat-coloured rectangles: edges and texture for SR to learn."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(8):
        fy, fx = rng.uniform(-0.3, 0.3, 2)
        phase = rng.uniform(0, 2 * np.pi)
        img += rng.uniform(0.05, 0.3, 3).astype(np.float32) * np.sin(fy * yy + fx * xx + phase)[..., None]
    img = (img - img.min()) / (img.max() - img.min() + 1e-6)
    for _ in range(12):
        y0, x0 = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 8))
        y1, x1 = y0 + int(rng.integers(4, h // 4)), x0 + int(rng.integers(4, w // 4))
        img[y0:y1, x0:x1] = 0.6 * img[y0:y1, x0:x1] + 0.4 * rng.uniform(0, 1, 3)
    return np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8)


def write_stills(out_dir: str, n: int, size: int, seed: int = 0) -> list[str]:
    """n seeded textured size x size stills as still_000.png, ... in out_dir."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        path = os.path.join(out_dir, f"still_{i:03d}.png")
        save_png(path, textured_still(size, size, rng))
        paths.append(path)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="sharkshark_tpu_torch.tools.make_derived_dataset")
    ap.add_argument("--src", required=True, help="folder of still images (.png, .jpg)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--holdout", nargs="+", required=True, help="filenames reserved for the val split")
    ap.add_argument("--seqs", type=int, default=200)
    ap.add_argument("--tempo", type=int, default=4)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--pan", type=int, default=8, help="max px pan per frame")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-tempo", type=int, default=1,
                    help=">1: val becomes panned T-frame crop sequences "
                    "(temporal-model eval) instead of one full frame")
    ap.add_argument("--noisy-sigma", type=float, default=0.0,
                    help=">0: also write val/noisy clips (GT + deterministic "
                    "Gaussian noise at this sigma/255) for denoise eval")
    args = ap.parse_args(argv)

    rng = random.Random(args.seed)
    paths = sorted(p for p in glob.glob(os.path.join(args.src, "*")) if p.lower().endswith((".png", ".jpg", ".jpeg")))
    holdout = set(args.holdout)
    train_paths = [p for p in paths if os.path.basename(p) not in holdout]
    val_paths = [p for p in paths if os.path.basename(p) in holdout]
    if not (train_paths and val_paths):
        raise ValueError(f"need train and held-out stills in {args.src}: {train_paths}, {val_paths}")

    imgs = []
    for p in train_paths:
        im = load_rgb(p)
        if min(im.shape[:2]) >= args.crop + args.pan * args.tempo + 1:
            imgs.append((os.path.basename(p), im))
    if not imgs:
        raise ValueError(f"no training still of at least {args.crop + args.pan * args.tempo + 1} px in {args.src}")
    print(f"train sources: {len(imgs)}, val sources: {len(val_paths)}")

    c, s, t, pan = args.crop, args.scale, args.tempo, args.pan
    for i in range(args.seqs):
        _, im = imgs[rng.randrange(len(imgs))]
        h, w = im.shape[:2]
        margin = pan * (t - 1)
        y0 = rng.randint(0, h - c - margin)
        x0 = rng.randint(0, w - c - margin)
        dy = rng.randint(-pan, pan)
        dx = rng.randint(-pan, pan)
        # keep the panned window inside the image
        y0 = min(max(y0, max(0, -dy * (t - 1))), h - c - max(0, dy * (t - 1)))
        x0 = min(max(x0, max(0, -dx * (t - 1))), w - c - max(0, dx * (t - 1)))
        flip = rng.random() < 0.5
        for j in range(t):
            y, x = y0 + dy * j, x0 + dx * j
            gt = im[y : y + c, x : x + c]
            if flip:
                gt = gt[:, ::-1]
            gt = np.ascontiguousarray(gt)
            seq = f"seq{i:04d}"
            save_png(os.path.join(args.out, "train", "GT", seq, f"{j:04d}.png"), gt)
            save_png(os.path.join(args.out, "train", "LR", seq, f"{j:04d}.png"), lr_of(gt, s))

    noise_rng = np.random.RandomState(args.seed + 1)
    for p in val_paths:
        im = load_rgb(p)
        h, w = im.shape[:2]
        seq = os.path.splitext(os.path.basename(p))[0]
        if args.val_tempo > 1:
            # panned T-frame crop sequence (the train set's motion)
            tv = args.val_tempo
            cv = min(c, h - pan * (tv - 1), w - pan * (tv - 1)) // s * s
            y0 = (h - cv - pan * (tv - 1)) // 2
            x0 = (w - cv - pan * (tv - 1)) // 2
            frames = [
                np.ascontiguousarray(im[y0 + pan * j : y0 + pan * j + cv, x0 + pan * j : x0 + pan * j + cv])
                for j in range(tv)
            ]
        else:
            frames = [im[: h // s * s, : w // s * s]]
        for j, gt in enumerate(frames):
            save_png(os.path.join(args.out, "val", "GT", seq, f"{j:04d}.png"), gt)
            save_png(os.path.join(args.out, "val", "LR", seq, f"{j:04d}.png"), lr_of(gt, s))
            if args.noisy_sigma > 0:
                noisy = gt.astype(np.float32) + noise_rng.normal(0.0, args.noisy_sigma, gt.shape)
                save_png(os.path.join(args.out, "val", "noisy", seq, f"{j:04d}.png"),
                         np.clip(noisy + 0.5, 0, 255).astype(np.uint8))
    print(f"wrote {args.seqs} train seqs (T={t}) + {len(val_paths)} val seqs to {args.out}")


if __name__ == "__main__":
    main()
