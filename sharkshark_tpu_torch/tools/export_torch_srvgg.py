"""Export SRVGG parameters from a checkpoint of this package's training
driver (configs/srvgg_derived.yml) to the reference's state-dict layout
(reference realesrgan/factory.py:18-82: body.{2i} convs, body.{2i+1}
PReLU, the tail at body.{2(num_conv+1)}, under 'params'), so that the
services' import path (torch_import.load_state_dict -> srvgg.from_torch,
DNI blending included) serves minted weights as it serves the reference's
realesr-general-x4v3.pth (counterpart of the JAX package's
tools/export_torch_srvgg.py).  The file is read back and checked.

    python -m sharkshark_tpu_torch.tools.export_torch_srvgg --ckpt CKPT_DIR_OR_FILE \\
        --out weights/minted/srvgg-derived-x4.pth [--num-conv 32]
"""

from __future__ import annotations

import argparse

from ..models import srvgg
from .export_torch import load_checkpoint_params, write_and_check

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="sharkshark_tpu_torch.tools.export_torch_srvgg")
    ap.add_argument("--ckpt", required=True, help="a ckpt_* file, or a checkpoint root (its newest)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-conv", type=int, default=32)
    args = ap.parse_args(argv)

    params = load_checkpoint_params(args.ckpt)
    cfg = srvgg.SRVGGConfig(num_conv=args.num_conv)
    if len(params["convs"]) != args.num_conv + 1:
        raise ValueError(f"{args.ckpt}: {len(params['convs']) - 1} body convs, --num-conv {args.num_conv}")
    res = write_and_check(params, srvgg.to_torch(params), args.out, lambda sd: srvgg.from_torch(sd, cfg),
                          wrapper="params")
    print(f"wrote {res['out']} ({res['tensors']} tensors); read back through from_torch: equal")
    return res


if __name__ == "__main__":
    main()
