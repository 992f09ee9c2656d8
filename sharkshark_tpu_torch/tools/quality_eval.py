"""Quality evaluation: PSNR / tOF / LPIPS between a ground-truth and a
prediction tree of frame folders (counterpart of the JAX package's
tools/quality_eval.py).  The reference computes these only inside its
training loop (metrics/metric_calculator.py); this runs the same metrics
(train/metrics.py) on any two trees, e.g. the training driver's test
outputs or a restream's frames.  Sequences are the subfolders the two
trees share; each is scored over its first min(len) frames.

    python -m sharkshark_tpu_torch.tools.quality_eval --gt data/Vid4/GT --pred results/Vid4 \\
        --metrics PSNR tOF [LPIPS] [--json out.json] [--device cpu]

LPIPS runs on the card unless --device cpu, with the given AlexNet and
linear weights, else the committed minted pair; PSNR and tOF are numpy.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..train.datasets import _imread_rgb, retrieve_files
from ..train.metrics import LPIPS, MetricCalculator
from ..utils import resolve_device

__all__ = ["main"]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="sharkshark_tpu_torch.tools.quality_eval")
    p.add_argument("--gt", required=True, help="a folder of sequence folders of frames")
    p.add_argument("--pred", required=True)
    p.add_argument("--metrics", nargs="+", default=["PSNR", "tOF"])
    p.add_argument("--psnr-colorspace", default="y", choices=["y", "rgb"])
    p.add_argument("--json", default=None)
    p.add_argument("--lpips-alexnet", default=None, help="torchvision alexnet .pth")
    p.add_argument("--lpips-linear", default=None, help="LPIPS linear .pth")
    p.add_argument("--device", default="cuda", help="LPIPS's torch device (default cuda)")
    args = p.parse_args(argv)

    lpips = None
    if "LPIPS" in args.metrics:
        dev = resolve_device(args.device)
        if args.lpips_alexnet or args.lpips_linear:
            lpips = LPIPS(args.lpips_alexnet, args.lpips_linear, device=dev)
        else:
            lpips = LPIPS.minted(dev)
    calc = MetricCalculator(metrics=args.metrics, psnr_colorspace=args.psnr_colorspace, lpips=lpips)

    seqs = sorted(set(os.listdir(args.gt)) & set(os.listdir(args.pred)))
    if not seqs:
        raise ValueError(f"no common sequences under {args.gt} and {args.pred}")
    for seq in seqs:
        gt = np.stack([_imread_rgb(f) for f in retrieve_files(os.path.join(args.gt, seq))])
        pred = np.stack([_imread_rgb(f) for f in retrieve_files(os.path.join(args.pred, seq))])
        n = min(len(gt), len(pred))
        res = calc.compute_sequence_metrics(seq, gt[:n], pred[:n])
        print(f"{seq}: " + " ".join(f"{k}={v:.4f}" for k, v in res.items()))

    avg = calc.average()
    print("average: " + " ".join(f"{k}={v:.4f}" for k, v in avg.items()))
    if args.json:
        calc.save(args.json, "eval")
        print(f"wrote {args.json}")
    return {"sequences": dict(calc.seq_results), "average": avg}


if __name__ == "__main__":
    main()
