"""Single-image upscale CLI of the PyTorch port (counterpart of the JAX
package's main/upscale_image.py): load an image, run the model, save the
result.

  python -m sharkshark_tpu_torch.main.upscale_image --input in.png --output out.png \\
      --model fsrcnn --weights fsrcnn_x4-T91.pth
  python -m sharkshark_tpu_torch.main.upscale_image --input in.png --output out.png \\
      --model zoo --model-name realesr-general-x4v3 --denoise-strength 0.5 [--device cpu]

The compute is `upscale_array`, on an (H, W, 3) float array, so that it
runs without PIL; `main` decodes and encodes with PIL.  It runs on the
card (bfloat16) unless --device cpu (float32).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import fsrcnn, torch_import, zoo
from ..upscale import tile_upscale
from ..utils import get_logger, resolve_device

__all__ = ["upscale_array", "main"]

log = get_logger("main.upscale_image")


def upscale_array(
    img: np.ndarray,
    *,
    model: str = "fsrcnn",
    model_name: str = "realesr-general-x4v3",
    weights: str | None = None,
    denoise_strength: float = 1.0,
    tile: int = 0,
    tile_pad: int = 10,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """img: (H, W, 3) float in [0, 1] -> (H*s, W*s, 3) float32 in [0, 1].
    model 'fsrcnn' (RGB riding the batch; seeded weights, with a warning,
    without `weights`) or 'zoo' (`model_name`, models/zoo.py).  tile > 0
    runs tile_upscale with tile_pad pixels of context.  Computes in
    bfloat16 on CUDA (as the services) and float32 on the CPU."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if model == "fsrcnn":
        if weights:
            params = fsrcnn.from_torch(torch_import.load_state_dict(weights), dev)
        else:
            log.warning("no FSRCNN weights given; using random init")
            params = fsrcnn.init_params(torch.Generator().manual_seed(0), device=dev)
        apply_fn, scale = fsrcnn.apply_rgb, 4
    elif model == "zoo":
        apply_fn, params, scale = zoo.build_sr_model(
            model_name, model_path=weights, denoise_strength=denoise_strength, device=dev)
    else:
        raise ValueError(f"model must be 'fsrcnn' or 'zoo', got {model!r}")
    params = torch_import.to_tensors(params, dev, dtype)
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)[None]).to(dev, dtype)
    with torch.inference_mode():
        if tile:
            out = tile_upscale(apply_fn, params, x, scale=scale, tile=tile, tile_pad=tile_pad)
        else:
            out = apply_fn(params, x)
        return torch.clamp(out[0].float(), 0.0, 1.0).cpu().numpy()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="sharkshark_tpu_torch.main.upscale_image")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--model", default="fsrcnn", choices=["fsrcnn", "zoo"],
                   help="fsrcnn = single-channel T91 net; zoo = --model-name")
    p.add_argument("--model-name", default="realesr-general-x4v3",
                   help="zoo entry (models/zoo.py)")
    p.add_argument("--weights", default=None, help=".pth path")
    p.add_argument("--denoise-strength", type=float, default=1.0)
    p.add_argument("--tile", type=int, default=0,
                   help="tile size for large images (0 = whole image)")
    p.add_argument("--tile-pad", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (cpu: the plain PyTorch path)")
    args = p.parse_args(argv)
    resolve_device(args.device)

    from PIL import Image

    img = np.asarray(Image.open(args.input).convert("RGB"), np.float32) / 255.0
    t0 = time.perf_counter()
    out = upscale_array(img, model=args.model, model_name=args.model_name, weights=args.weights,
                        denoise_strength=args.denoise_strength, tile=args.tile, tile_pad=args.tile_pad,
                        device=args.device)
    dt = time.perf_counter() - t0
    Image.fromarray((out * 255 + 0.5).astype(np.uint8)).save(args.output)
    print(f"{args.input} {img.shape[1]}x{img.shape[0]} -> "
          f"{args.output} {out.shape[1]}x{out.shape[0]} ({dt:.2f}s incl. weight loading)")


if __name__ == "__main__":
    main()
