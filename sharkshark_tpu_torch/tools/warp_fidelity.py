"""K3's fidelity against the exact gather sampler (counterpart of the
JAX package's tools/warp_fidelity.py).

Warps a still at 2160x3840 along smooth synthetic flows of increasing
magnitude, as EGVSR's flows are (coarse random knots every `--cells`
pixels, upsampled bilinearly, times `--disps` pixels), and prints one
JSON row a magnitude: the PSNR and the largest absolute error of K3
(`ops.warp.backward_warp_fast` through its operator, the image in bf16)
against the float32 plain gather (`ops.warp.backward_warp`), then all
rows as one {"warp_fidelity": [...]} line.

    python -m sharkshark_tpu_torch.tools.warp_fidelity [--image PATH]
        [--size 2160 3840] [--disps 4 20 90] [--cells 32] [--device cuda|cpu]

The rows are the JAX tool's.  Its `window` column names which of the
Pallas kernel's two windows ran (fast or full, `banded_warp_bases`);
the port's K3 has one route for any flow, so the column reads "single".
Without `--image` the still is the textured still that
`make_derived_dataset.write_stills` writes, from seed 0, at the size
asked.  The
coarse knots come from a torch.Generator seeded with the magnitude (the
JAX tool's jax.random.PRNGKey(int(disp))), so the flows differ from the
JAX tool's.  `--device cpu` runs K3's plain version (the tests);
without it a host without CUDA raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import resize
from ..ops.warp import backward_warp, backward_warp_fast
from ..utils import resolve_device
from .make_derived_dataset import load_rgb, textured_still

__all__ = ["coarse_field", "smooth_flow", "warp_pair", "fidelity_row", "run", "main"]

WINDOW = "single"  # K3's one route (the JAX kernel's "fast" or "full")
STILL_SEED = 0  # the default still's seed


def coarse_field(h: int, w: int, cells: int, disp: float) -> torch.Tensor:
    """Random knots in [-1, 1), (1, h // cells, w // cells, 2) float32,
    from a torch.Generator seeded with int(disp)."""
    g = torch.Generator().manual_seed(int(disp))
    return torch.rand((1, h // cells, w // cells, 2), generator=g) * 2.0 - 1.0


def smooth_flow(coarse: torch.Tensor, h: int, w: int, disp: float) -> torch.Tensor:
    """The knots upsampled bilinearly to (1, h, w, 2), times disp pixels,
    in float32 (jax.image.resize's bilinear, as ops.resize computes it)."""
    return (resize(coarse.float(), (h, w), "bilinear") * disp).float()


def warp_pair(x: torch.Tensor, flow: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K3's warp of x in bf16, the float32 gather's warp of x), both
    float32 on x's device."""
    got = backward_warp_fast(x.to(torch.bfloat16).contiguous(), flow.float().contiguous()).float()
    return got, backward_warp(x.float(), flow.float())


def fidelity_row(x: torch.Tensor, flow: torch.Tensor, disp: float) -> dict:
    got, ref = warp_pair(x, flow)
    mse = float(torch.mean((got - ref).double() ** 2))
    return {"disp_px": disp, "window": WINDOW, "psnr_db": round(float(10 * np.log10(1.0 / max(mse, 1e-12))), 1),
            "max_abs_err": round(float((got - ref).abs().max()), 5)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="warp_fidelity", description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", default=None, help="source image (resized to --size); default: a seeded still")
    ap.add_argument("--size", nargs=2, type=int, default=[2160, 3840])
    ap.add_argument("--disps", nargs="+", type=float, default=[4.0, 20.0, 90.0])
    ap.add_argument("--cells", type=int, default=32, help="flow knot spacing (px)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def load_image(path: str | None, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8: the file resized as the JAX tool does, or the
    textured still from STILL_SEED."""
    if path is None:
        return textured_still(h, w, np.random.default_rng(STILL_SEED))
    from PIL import Image

    return np.asarray(Image.fromarray(load_rgb(path)).resize((w, h)))


def run(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    h, w = args.size
    img = load_image(args.image, h, w)
    x = torch.from_numpy(img.astype(np.float32)[None] / 255.0).to(dev)
    rows = []
    for disp in args.disps:
        flow = smooth_flow(coarse_field(h, w, args.cells, disp).to(dev), h, w, disp)
        row = fidelity_row(x, flow, disp)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"warp_fidelity": rows}), flush=True)
    return rows


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
