"""Export BSVD-32 or BSVD-64 parameters from a checkpoint of this
package's training driver (configs/bsvd_derived.yml, `variant: 32|64`) to the reference's two-net state-dict
layout (`base_model.nets_list.{0,1}.<block>.convblock.<i>...`: reference
src/upscale/model/bsvd/model.py:276-306), so that the services' import
path (torch_import.load_state_dict -> bsvd.from_torch) serves minted
denoise weights as it serves bsvd-32.pth (counterpart of the JAX
package's tools/export_torch_bsvd.py).  The file is read back through
from_torch at the variant's config and checked leaf by leaf.

    python -m sharkshark_tpu_torch.tools.export_torch_bsvd --ckpt CKPT_DIR_OR_FILE \\
        --out weights/minted/bsvd-derived-32.pth [--variant 64]
"""

from __future__ import annotations

import argparse

from ..models import bsvd
from .export_torch import load_checkpoint_params, write_and_check

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="sharkshark_tpu_torch.tools.export_torch_bsvd")
    ap.add_argument("--ckpt", required=True, help="a ckpt_* file, or a checkpoint root (its newest)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--variant", type=int, default=32, choices=(32, 64), help="BSVD-32 or BSVD-64")
    args = ap.parse_args(argv)

    cfg = bsvd.BSVD_64 if args.variant == 64 else bsvd.BSVD_32
    params = load_checkpoint_params(args.ckpt)
    widths = tuple(params["temp1"][k]["w"].shape[-1] for k in ("inc1", "down0", "down1"))
    if widths != cfg.chns:
        raise ValueError(f"the checkpoint's widths {widths} are not BSVD-{args.variant}'s {cfg.chns}")
    res = write_and_check(params, bsvd.to_torch(params), args.out, lambda sd: bsvd.from_torch(sd, cfg))
    print(f"wrote {res['out']} ({res['tensors']} tensors); read back through from_torch: equal")
    return res


if __name__ == "__main__":
    main()
