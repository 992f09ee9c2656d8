"""SR model zoo: names -> architecture, config, weight source
(counterpart of the JAX package's models/zoo.py; the reference's
RealESRGAN factory table, src/upscale/model/realesrgan/factory.py:112-157).

Each entry names its network, its config, the official release URL of
its weights and the DNI pairing for denoise-strength interpolation.
`build_sr_model` returns a ready (apply_fn, params, scale) triple on a
device; the weights come from an explicit path, the local weight
directory (`SHARKSHARK_WEIGHT_DIR`, default ./weights, read at each call)
or, where the host can reach it, the release URL.  SRVGG entries run
their body through K4 (srvgg.resolve_conv_stack).
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple

import torch

from ..utils import get_logger, resolve_device
from . import rrdbnet, srvgg, torch_import

__all__ = ["ZOO", "ZooEntry", "WEIGHT_DIR", "default_weight_dir", "fetch_weights", "build_sr_model"]

log = get_logger("models.zoo")

WEIGHT_DIR = "./weights"  # where SHARKSHARK_WEIGHT_DIR is unset


def default_weight_dir() -> str:
    """The local weight directory: SHARKSHARK_WEIGHT_DIR, else WEIGHT_DIR."""
    return os.environ.get("SHARKSHARK_WEIGHT_DIR", WEIGHT_DIR)


class ZooEntry(NamedTuple):
    arch: str                      # 'rrdb' | 'srvgg'
    cfg: Any
    scale: int
    urls: tuple[str, ...]
    dni_partner: str | None = None  # weights blended by denoise strength


_RELEASES = "https://github.com/xinntao/Real-ESRGAN/releases/download"

ZOO: dict[str, ZooEntry] = {
    "RealESRGAN_x4plus": ZooEntry(
        "rrdb", rrdbnet.X4PLUS, 4, (f"{_RELEASES}/v0.1.0/RealESRGAN_x4plus.pth",),
    ),
    "RealESRNet_x4plus": ZooEntry(
        "rrdb", rrdbnet.X4PLUS, 4, (f"{_RELEASES}/v0.1.1/RealESRNet_x4plus.pth",),
    ),
    "RealESRGAN_x4plus_anime_6B": ZooEntry(
        "rrdb", rrdbnet.X4PLUS_ANIME_6B, 4, (f"{_RELEASES}/v0.2.2.4/RealESRGAN_x4plus_anime_6B.pth",),
    ),
    "RealESRGAN_x2plus": ZooEntry(
        "rrdb", rrdbnet.X2PLUS, 2, (f"{_RELEASES}/v0.2.1/RealESRGAN_x2plus.pth",),
    ),
    "realesr-animevideov3": ZooEntry(
        "srvgg", srvgg.ANIMEVIDEO_V3, 4, (f"{_RELEASES}/v0.2.5.0/realesr-animevideov3.pth",),
    ),
    "realesr-general-x4v3": ZooEntry(
        "srvgg", srvgg.GENERAL_X4V3, 4,
        (f"{_RELEASES}/v0.2.5.0/realesr-general-wdn-x4v3.pth", f"{_RELEASES}/v0.2.5.0/realesr-general-x4v3.pth"),
        dni_partner="realesr-general-wdn-x4v3",
    ),
}


def _download(url: str, path: str) -> None:
    import requests

    log.info("downloading %s", url)
    r = requests.get(url, timeout=120)
    r.raise_for_status()
    with open(path, "wb") as f:
        f.write(r.content)


def fetch_weights(name: str, weight_dir: str | None = None, need_partner: bool = True) -> list[str]:
    """Local paths of the .pth files of a zoo entry, each downloaded into
    `weight_dir` (default: default_weight_dir()) where it is absent; raises
    FileNotFoundError naming the URL when a file is absent and its
    download fails.  need_partner=False skips the DNI partner (listed
    first in urls): a denoise strength >= 1 never reads it."""
    entry = ZOO[name]
    weight_dir = default_weight_dir() if weight_dir is None else weight_dir
    urls = entry.urls
    if not need_partner and entry.dni_partner and len(urls) > 1:
        urls = urls[-1:]
    paths = []
    for url in urls:
        path = os.path.join(weight_dir, os.path.basename(url))
        if not os.path.isfile(path):
            os.makedirs(weight_dir, exist_ok=True)
            try:
                _download(url, path)
            except Exception as ex:
                raise FileNotFoundError(
                    f"weights for {name!r} not found at {path} and download failed ({ex}); "
                    f"fetch manually from {url}"
                ) from ex
        paths.append(path)
    return paths


def build_sr_model(
    name: str,
    model_path: str | None = None,
    denoise_strength: float = 1.0,
    weight_dir: str | None = None,
    random_init: bool = False,
    device: str | torch.device = "cuda",
    conv_stack: int | None = None,
) -> tuple[Callable, Any, int]:
    """(apply_fn(params, x), params, scale) for a zoo model, its float32
    params on `device` (default cuda; a CUDA device without CUDA raises).

    denoise_strength < 1 blends the wdn DNI partner as the reference does
    (factory.py:152-157), when the weights come from the weight directory.
    random_init: seeded weights (generator seed 0) instead of a file.
    conv_stack: K4's layers a call for an SRVGG body (None: the config's
    default, srvgg.resolve_conv_stack)."""
    dev = resolve_device(device)
    entry = ZOO[name]
    model = srvgg if entry.arch == "srvgg" else rrdbnet
    if random_init:
        params = model.init_params(torch.Generator().manual_seed(0), entry.cfg, dev)
    else:
        if model_path is not None:
            paths = [model_path]
        else:
            paths = fetch_weights(name, weight_dir, need_partner=denoise_strength < 1.0)
        sd = torch_import.load_state_dict(paths[-1])
        if entry.dni_partner and denoise_strength < 1.0 and len(paths) > 1:
            sd = torch_import.dni_blend(sd, torch_import.load_state_dict(paths[0]), denoise_strength)
        params = model.from_torch(sd, entry.cfg, dev)

    if entry.arch == "srvgg":
        stack = srvgg.resolve_conv_stack(entry.cfg, conv_stack)

        def fn(p, x):
            return srvgg.apply(p, x, cfg=entry.cfg, conv_stack=stack)
    else:
        if conv_stack:
            raise ValueError(f"conv_stack={conv_stack}: {name} has no SRVGG body for K4")

        def fn(p, x):
            return rrdbnet.apply(p, x, cfg=entry.cfg)
    return fn, params, entry.scale
