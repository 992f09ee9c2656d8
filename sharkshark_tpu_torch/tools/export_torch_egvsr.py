"""Export EGVSR (FRNet) parameters from a checkpoint of this package's
training driver (configs/egvsr_derived.yml, or a GAN config's generator)
to the reference's state-dict layout (fnet.encoderN / decoderN / flow,
srnet.conv_in / resblocks / conv_out: reference
src/upscale/model/egvsr/egvsr.py:16-130), so that the services' import
path (torch_import.load_state_dict -> egvsr.from_torch) serves minted
weights as it serves EGVSR_iter420000.pth (counterpart of the JAX
package's tools/export_torch_egvsr.py).  --degradation BD adds the
reference's BicubicUpsample buffer, by which config_from_torch tells a
BD checkpoint.  The file is read back and checked.

    python -m sharkshark_tpu_torch.tools.export_torch_egvsr --ckpt CKPT_DIR_OR_FILE \\
        --out weights/minted/egvsr-derived-x4.pth [--nb 10] [--degradation BI|BD]
"""

from __future__ import annotations

import argparse

from ..models import egvsr
from ..models.torch_import import load_state_dict
from .export_torch import load_checkpoint_params, write_and_check

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="sharkshark_tpu_torch.tools.export_torch_egvsr")
    ap.add_argument("--ckpt", required=True, help="a ckpt_* file, or a checkpoint root (its newest)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--nb", type=int, default=10)
    ap.add_argument("--degradation", default="BI", choices=["BI", "BD"])
    args = ap.parse_args(argv)

    params = load_checkpoint_params(args.ckpt)
    if len(params["srnet"]["blocks"]) != args.nb:
        raise ValueError(f"{args.ckpt}: {len(params['srnet']['blocks'])} residual blocks, --nb {args.nb}")
    cfg = egvsr.EGVSRConfig(nb=args.nb, degradation=args.degradation)
    res = write_and_check(params, egvsr.to_torch(params, cfg), args.out, lambda sd: egvsr.from_torch(sd, cfg))
    got = egvsr.config_from_torch(load_state_dict(args.out))
    if got.degradation != args.degradation or got.nb != args.nb:
        raise RuntimeError(f"{args.out}: config_from_torch reads {got}")
    print(f"wrote {res['out']} ({res['tensors']} tensors); read back through from_torch: equal ({got})")
    return res


if __name__ == "__main__":
    main()
