"""Mint an LPIPS metric without downloads: the AlexNet backbone and the
linear calibration, trained on local stills (counterpart of the JAX
package's tools/mint_lpips.py).

The reference ships torchvision's pretrained AlexNet and the LPIPS v0.1
linear weights (its metrics/LPIPS/); neither can be fetched here.  This
tool trains the same architecture (the AlexNet `.features` stack with
the five LPIPS taps, and the clamped linear calibration) end to end on a
2AFC-style ranking objective built from stills: for a reference patch x
and one distortion family at two strengths, the stronger distortion must
score farther.  The six families (blur, noise, pixelate, contrast,
color, posterize), the triplet sampler, the initialisation, the
objective (softplus(d_weak - d_strong + 0.05)), the global-norm clip at
1 and Adam on a cosine-decay schedule are the JAX tool's; the rng is
numpy's, so a seed draws the same triplets and initial weights.

    python -m sharkshark_tpu_torch.tools.mint_lpips [--src DIR] [--holdout NAME]
        [--steps 1500] [--batch 8] [--patch 64] [--lr 1e-3] [--seed 0]
        [--out-dir weights/minted] [--device cuda|cpu]

Without `--src` the stills are ten seeded 256x256 ones that
`make_derived_dataset.write_stills` writes to a temporary directory
(`--holdout` then names one of them, still_000.png by default).

Outputs, under torchvision's and LPIPS v0.1's key names, loadable by
train/metrics.LPIPS:
  lpips-alex-derived.pth  features.{0,3,6,8,10}.{weight,bias}
  lpips-lin-derived.pth   lin{0..4}.model.1.weight (1, C, 1, 1)
They are written to a staging directory and validated through
train/metrics.LPIPS on the held-out still at held-out strengths: every
family must rank its five strengths with Spearman's rho >= 0.9 and score
the strongest more than twice the weakest.  The tool prints that
ranking check and moves the files into --out-dir only when it passes;
otherwise it exits with an error and ships nothing.  Pass a temporary
--out-dir to try it: the default replaces the committed pair.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import conv2d
from ..train.metrics import _SCALE, _SHIFT, LPIPS
from ..train.vsr import make_optimizer
from ..utils import resolve_device

__all__ = ["SPECS", "CHANNELS", "DISTORTIONS", "init_params", "features", "distance", "ranking_loss",
           "load_images", "sample_triplets", "cosine_decay", "clip_by_global_norm", "export", "check_ranking",
           "stills", "train", "main"]

# AlexNet .features conv specs: idx -> ((out, in, kh, kw), stride, pad)
SPECS = {
    0: ((64, 3, 11, 11), 4, 2),
    3: ((192, 64, 5, 5), 1, 2),
    6: ((384, 192, 3, 3), 1, 1),
    8: ((256, 384, 3, 3), 1, 1),
    10: ((256, 256, 3, 3), 1, 1),
}
CHANNELS = (64, 192, 384, 256, 256)
DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "weights", "minted")


# ---------------------------------------------------------------------------
# distortion families (numpy, float [0,1] patches, strength s in (0,1])
# ---------------------------------------------------------------------------

def _blur(x, s, rng):
    import cv2

    sigma = 0.5 + 3.0 * s
    return cv2.GaussianBlur(x, (0, 0), sigmaX=sigma, sigmaY=sigma)


def _noise(x, s, rng):
    return np.clip(x + rng.normal(0, 0.25 * s, x.shape).astype(np.float32), 0, 1)


def _pixelate(x, s, rng):
    import cv2

    h, w = x.shape[:2]
    # exponential factor spacing keeps adjacent strengths distinguishable
    # at the high end
    f = max(1, int(round(2.0 ** (3.2 * s))))
    small = cv2.resize(x, (max(1, w // f), max(1, h // f)), interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


def _contrast(x, s, rng):
    m = x.mean(axis=(0, 1), keepdims=True)
    return np.clip((x - m) * (1.0 - 0.85 * s) + m, 0, 1)


def _color(x, s, rng):
    gains = 1.0 + (rng.uniform(-1, 1, (1, 1, 3)) * 0.6 * s).astype(np.float32)
    return np.clip(x * gains, 0, 1)


def _posterize(x, s, rng):
    levels = max(2, int(round(24 * (1.0 - s) + 2)))
    return np.round(x * (levels - 1)) / (levels - 1)


DISTORTIONS = {
    "blur": _blur,
    "noise": _noise,
    "pixelate": _pixelate,
    "contrast": _contrast,
    "color": _color,
    "posterize": _posterize,
}


# ---------------------------------------------------------------------------
# the model: train/metrics.LPIPS's arithmetic on a trainable tree
# ---------------------------------------------------------------------------

def init_params(seed: int) -> dict[str, np.ndarray]:
    """He-normal HWIO convs, zero biases and linear weights of 0.1, from
    np.random.default_rng(seed) (the JAX tool's draws)."""
    rng = np.random.default_rng(seed)
    params = {}
    for i, (shape, _, _) in SPECS.items():
        o, c, kh, kw = shape
        params[f"w{i}"] = (rng.normal(size=(kh, kw, c, o)) * np.sqrt(2.0 / (c * kh * kw))).astype(np.float32)
        params[f"b{i}"] = np.zeros((o,), np.float32)
    for k, c in enumerate(CHANNELS):
        params[f"lin{k}"] = np.full((c,), 0.1, np.float32)
    return params


def features(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """x: (N, H, W, 3) normalised -> the five ReLU taps (NHWC), a 3x3/2
    max pool after the first two."""
    taps, y = [], x
    for i, (_, stride, pad) in SPECS.items():
        y = torch.relu(conv2d(y, params[f"w{i}"], params[f"b{i}"], stride=stride, padding=pad))
        taps.append(y)
        if i in (0, 3):
            y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    return taps


def distance(params: dict, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """img0/img1: (N, H, W, 3) in [-1, 1] -> (N,): LPIPS's normalisation
    and clamped-linear formula, except that the unit norm is
    sqrt(sum(x^2) + 1e-10), whose gradient stays finite at an all-zero
    tap (a dead ReLU pixel); forward values match train/metrics.LPIPS's
    to ~1e-10."""
    shift = torch.tensor(_SHIFT, device=img0.device)
    scale = torch.tensor(_SCALE, device=img0.device)
    f0 = features(params, (img0 - shift) / scale)
    f1 = features(params, (img1 - shift) / scale)
    total = 0.0
    for k, (a, b) in enumerate(zip(f0, f1)):
        a = a / torch.sqrt((a * a).sum(dim=-1, keepdim=True) + 1e-10)
        b = b / torch.sqrt((b * b).sum(dim=-1, keepdim=True) + 1e-10)
        w = torch.clamp(params[f"lin{k}"], min=0)[:, None]
        total = total + (((a - b) ** 2) @ w).mean(dim=(1, 2))[:, 0]
    return total


def ranking_loss(params: dict, ref, weak, strong):
    """The logistic ranking objective: the stronger distortion must score
    farther.  Returns (loss, (mean d_weak, mean d_strong))."""
    d_weak = distance(params, ref, weak)
    d_strong = distance(params, ref, strong)
    return F.softplus(d_weak - d_strong + 0.05).mean(), (d_weak.mean(), d_strong.mean())


# ---------------------------------------------------------------------------
# training data
# ---------------------------------------------------------------------------

def load_images(src: str, holdout: str):
    """The .png stills under src as float32 [0,1] arrays: (train, held
    out or None)."""
    from PIL import Image

    train_imgs, hold_img = [], None
    for p in sorted(glob.glob(os.path.join(src, "*.png"))):
        im = Image.open(p)
        if im.mode != "RGB":
            im = im.convert("RGB")
        arr = np.asarray(im).astype(np.float32) / 255.0
        if os.path.basename(p) == holdout:
            hold_img = arr
        else:
            train_imgs.append(arr)
    if not train_imgs:
        raise SystemExit(f"no .png images under {src}")
    return train_imgs, hold_img


def sample_triplets(imgs, rng, batch: int, patch: int):
    """-> (ref, weak, strong) arrays (B, patch, patch, 3) in [-1, 1]."""
    refs, weaks, strongs = [], [], []
    names = list(DISTORTIONS)
    for _ in range(batch):
        img = imgs[rng.integers(len(imgs))]
        h, w = img.shape[:2]
        y = rng.integers(0, h - patch + 1)
        x = rng.integers(0, w - patch + 1)
        ref = img[y : y + patch, x : x + patch]
        fn = DISTORTIONS[names[rng.integers(len(names))]]
        s_weak = float(rng.uniform(0.05, 0.45))
        s_strong = min(1.0, s_weak + float(rng.uniform(0.3, 0.55)))
        refs.append(ref)
        weaks.append(fn(ref, s_weak, rng))
        strongs.append(fn(ref, s_strong, rng))

    def to(lst):
        return np.stack(lst).astype(np.float32) * 2.0 - 1.0

    return to(refs), to(weaks), to(strongs)


# ---------------------------------------------------------------------------
# train / validate / export
# ---------------------------------------------------------------------------

def cosine_decay(lr: float, steps: int, alpha: float = 0.05):
    """optax.cosine_decay_schedule(lr, steps, alpha) as a function of the
    update count."""

    def sched(count: int) -> float:
        t = min(count, steps) / steps
        return lr * ((1 - alpha) * 0.5 * (1 + np.cos(np.pi * t)) + alpha)

    return sched


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float = 1.0) -> None:
    """optax.clip_by_global_norm, in place: gradients with a global norm
    above max_norm are scaled to it."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def export(params: dict, stage: str) -> tuple[str, str]:
    """The torchvision AlexNet and LPIPS v0.1 linear state dicts of
    `params`, written into `stage`: (alex path, lin path)."""
    alex_sd = {}
    for i in SPECS:
        alex_sd[f"features.{i}.weight"] = params[f"w{i}"].detach().cpu().permute(3, 2, 0, 1).contiguous()
        alex_sd[f"features.{i}.bias"] = params[f"b{i}"].detach().cpu().clone()
    lin_sd = {f"lin{k}.model.1.weight": torch.clamp(params[f"lin{k}"].detach().cpu(), min=0)[None, :, None, None]
              .contiguous() for k in range(len(CHANNELS))}
    alex_path = os.path.join(stage, "lpips-alex-derived.pth")
    lin_path = os.path.join(stage, "lpips-lin-derived.pth")
    torch.save(alex_sd, alex_path)
    torch.save(lin_sd, lin_path)
    return alex_path, lin_path


def check_ranking(model: LPIPS, hold_img: np.ndarray) -> dict:
    """The validation gate on the held-out still's centre 128x128 patch:
    per family, the distances at five held-out strengths, Spearman's rho
    against the strength order and whether the family passes; and the
    self-distance.  Prints one line a family."""
    h, w = hold_img.shape[:2]
    py, px = (h - 128) // 2, (w - 128) // 2
    patch = hold_img[py : py + 128, px : px + 128]
    vrng = np.random.default_rng(123)
    strengths = [0.15, 0.35, 0.55, 0.75, 0.95]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[None] * 2 - 1, np.float32)).to(model.device)

    families = {}
    with torch.no_grad():
        for name, fn in DISTORTIONS.items():
            ds = [float(model(t(patch), t(fn(patch, s, vrng)))[0]) for s in strengths]
            # rank correlation with strength >= 0.9 and the strongest far
            # beyond the weakest (a distance of 0 at the weakest strength
            # is legitimate: pixelate at s=0.15 is the identity)
            order = np.argsort(np.argsort(ds))
            rho = float(np.corrcoef(order, np.arange(len(ds)))[0, 1])
            ok = bool(rho >= 0.9 and ds[-1] > 2.0 * ds[0] and ds[-1] > 0.01 and all(d >= 0 for d in ds))
            families[name] = {"ok": ok, "rho": rho, "distances": ds}
            print(f"{name:10s} {'OK ' if ok else 'FAIL'} rho={rho:.2f} " + " ".join(f"{d:.4f}" for d in ds),
                  flush=True)
        zero = float(model(t(patch), t(patch))[0])
    print(f"self-distance {zero:.2e}", flush=True)
    return {"families": families, "self_distance": zero,
            "ok": all(f["ok"] for f in families.values()) and bool(np.isfinite(zero))}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mint_lpips", description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None, help="folder of .png stills; default: seeded stills")
    ap.add_argument("--holdout", default=None, help="the validation still (default shark3.png, or "
                                                    "still_000.png for the seeded stills)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def stills(src: str | None, holdout: str | None, tmp: str, seed: int = 0):
    """(train stills, held-out still or None) from src, or from ten seeded
    256x256 stills written into tmp (held out: still_000.png)."""
    if src is None:
        from .make_derived_dataset import write_stills

        src = os.path.join(tmp, "stills")
        os.makedirs(src)
        write_stills(src, 10, 256, seed=seed)
        holdout = holdout or "still_000.png"
    return load_images(src, holdout or "shark3.png")


def train(train_imgs, steps: int, batch: int = 8, patch: int = 64, lr: float = 1e-3, seed: int = 0,
          device: str | torch.device = "cuda") -> tuple[dict, list[float]]:
    """`steps` updates of the ranking objective from init_params(seed) on
    triplets drawn with np.random.default_rng(seed): (params, losses)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = {k: torch.from_numpy(v).to(dev).requires_grad_(True) for k, v in init_params(seed).items()}
    leaves = list(params.values())
    opt = make_optimizer(leaves, lr, 0.9, 0.999)
    sched = cosine_decay(lr, steps)
    losses = []
    for it in range(steps):
        ref, weak, strong = (torch.from_numpy(a).to(dev) for a in sample_triplets(train_imgs, rng, batch, patch))
        loss, (dw, ds) = ranking_loss(params, ref, weak, strong)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm([p.grad for p in leaves])
        for group in opt.param_groups:
            group["lr"] = sched(it)
        opt.step()
        losses.append(float(loss.detach()))
        if it % 100 == 0 or it == steps - 1:
            print(f"step {it:5d} loss {losses[-1]:.4f} d_weak {float(dw.detach()):.4f} "
                  f"d_strong {float(ds.detach()):.4f}", flush=True)
    return params, losses


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="mint_lpips_") as tmp:
        train_imgs, hold_img = stills(args.src, args.holdout, tmp, args.seed)
        params, losses = train(train_imgs, args.steps, args.batch, args.patch, args.lr, args.seed, dev)
        # export to a staging directory; the files reach --out-dir only
        # once the ranking check passes
        stage = os.path.join(tmp, "stage")
        os.makedirs(stage)
        alex_path, lin_path = export(params, stage)
        if hold_img is None:
            hold_img = train_imgs[0]
            print("WARNING: holdout image not found; validating on a train image")
        check = check_ranking(LPIPS(alex_path, lin_path, dev), hold_img)
        if not check["ok"]:
            raise SystemExit("monotonicity validation FAILED — not shipping")
        os.makedirs(args.out_dir, exist_ok=True)
        shipped = []
        for p in (alex_path, lin_path):
            dst = os.path.join(args.out_dir, os.path.basename(p))
            shutil.move(p, dst)
            shipped.append(dst)
            print(f"shipped {dst} ({os.path.getsize(dst) / 1e6:.1f} MB)", flush=True)
    return {"losses": losses, "check": check, "shipped": shipped}


if __name__ == "__main__":
    main()
