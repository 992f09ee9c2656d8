"""Ingest model weights obtained elsewhere into the local weight
directory (counterpart of the JAX package's tools/ingest_weights.py).

The zoo downloads its release files (models/zoo.py fetch_weights) where
a network is at hand; without one, a user copies `.pth` files in by
hand.  This tool validates a candidate file before it lands:

    python -m sharkshark_tpu_torch.tools.ingest_weights --model realesr-general-x4v3 x.pth
    python -m sharkshark_tpu_torch.tools.ingest_weights --model bsvd-32 bsvd-32.pth
    python -m sharkshark_tpu_torch.tools.ingest_weights --model egvsr EGVSR_iter420000.pth
        [--weight-dir DIR] [--device cuda|cpu]

It loads the checkpoint on the CPU with weights only, converts it
through the port's `from_torch` importer of the model (srvgg, rrdbnet,
bsvd, egvsr; EGVSR's config is inferred from the file, as
`egvsr.config_from_torch` does), checks every parameter's shape against
the model's own, and runs a tiny forward pass on `--device` (the card
unless asked for the CPU).  Only then does it copy the file, byte for
byte, into `--weight-dir` (default $SHARKSHARK_WEIGHT_DIR, else
./weights) under the name the zoo resolves, or the CANONICAL name for
bsvd-32, bsvd-64 and egvsr.  It never downloads anything.
"""

from __future__ import annotations

import argparse
import os
import shutil

import torch

from ..models import bsvd, egvsr, rrdbnet, srvgg, torch_import
from ..models.zoo import ZOO, default_weight_dir
from ..utils import resolve_device

__all__ = ["CANONICAL", "validate", "install_name", "main"]

CANONICAL = {
    # zoo names resolve through models/zoo.py; these are extras
    "bsvd-32": "bsvd-32.pth",
    "bsvd-64": "bsvd-64.pth",
    "egvsr": "EGVSR_iter420000.pth",
}


def _shapes(tree, path: str = "") -> dict[str, tuple]:
    """{path: shape} of the tensors of a nested dict/list."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _shapes(sub, f"{path}.{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _shapes(sub, f"{path}[{i}]").items()}
    return {path: tuple(tree.shape)}


def _check_shapes(model: str, params, ref) -> None:
    """Every leaf of the imported tree is one of the model's own, with its
    shape (a bias the file leaves out stays out: from_torch allows it)."""
    got, want = _shapes(params), _shapes(ref)
    for path in sorted(got):
        if got[path] != want.get(path):
            raise ValueError(f"{model}: parameter {path} has shape {got[path]}, the model's is {want.get(path)}")


def validate(model: str, path: str, device: str | torch.device = "cuda") -> None:
    """Load `path` as `model`'s weights and run a tiny forward pass;
    raises (KeyError, ValueError or SystemExit) where it does not fit."""
    dev = resolve_device(device)
    sd = torch_import.load_state_dict(path)
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros((1, 8, 8, 3), device=dev)
    with torch.inference_mode():
        if model in ZOO:
            entry = ZOO[model]
            mod = srvgg if entry.arch == "srvgg" else rrdbnet
            params = mod.from_torch(sd, entry.cfg)
            _check_shapes(model, params, mod.init_params(gen, entry.cfg))
            out = mod.apply(torch_import.to_tensors(params, dev), x, cfg=entry.cfg)
            if tuple(out.shape[1:3]) != (8 * entry.scale, 8 * entry.scale):
                raise ValueError(f"{model}: a forward pass gave {tuple(out.shape)}")
        elif model in ("bsvd-32", "bsvd-64"):
            cfg = bsvd.BSVD_32 if model == "bsvd-32" else bsvd.BSVD_64
            params = bsvd.from_torch(sd, cfg)
            _check_shapes(model, params, bsvd.init_params(gen, cfg))
            out = bsvd.apply_single(torch_import.to_tensors(params, dev),
                                    torch.zeros((1, 8, 8, cfg.in_ch), device=dev), cfg=cfg)
            if tuple(out.shape) != (1, 8, 8, cfg.out_ch):
                raise ValueError(f"{model}: a forward pass gave {tuple(out.shape)}")
        elif model == "egvsr":
            # nb, nf and the degradation from the file: the reference's
            # production EGVSR_iter420000.pth is nb=10, not the class default
            cfg = egvsr.config_from_torch(sd)
            params = egvsr.from_torch(sd, cfg)
            _check_shapes(model, params, egvsr.init_params(gen, cfg))
            state = egvsr.init_recurrent_state(1, 8, 8, cfg, device=dev)
            out, _ = egvsr.infer_step(torch_import.to_tensors(params, dev), state, x, cfg=cfg)
            if tuple(out.shape) != (1, 32, 32, 3):
                raise ValueError(f"{model}: a forward pass gave {tuple(out.shape)}")
        else:
            raise SystemExit(f"unknown model {model!r}; choose from {sorted(ZOO) + sorted(CANONICAL)}")


def install_name(model: str, path: str) -> str:
    """The file name the zoo or the services look for: a zoo entry keeps
    the release name it is handed (the DNI pair realesr-general-{wdn-,}
    x4v3 is told apart by it), else takes the entry's last release name."""
    if model not in ZOO:
        return CANONICAL[model]
    name = os.path.basename(path)
    targets = [os.path.basename(u) for u in ZOO[model].urls]
    return name if name in targets else targets[-1]


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(prog="ingest_weights", description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="candidate .pth file")
    ap.add_argument("--model", required=True)
    ap.add_argument("--weight-dir", default=default_weight_dir())
    ap.add_argument("--device", default="cuda", help="the forward pass's device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    validate(args.model, args.path, args.device)
    os.makedirs(args.weight_dir, exist_ok=True)
    dst = os.path.join(args.weight_dir, install_name(args.model, args.path))
    shutil.copy2(args.path, dst)
    print(f"validated and installed: {dst}")
    return dst


if __name__ == "__main__":
    main()
