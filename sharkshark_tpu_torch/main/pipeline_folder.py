"""Batch folder driver of the PyTorch port (counterpart of the JAX
package's main/pipeline_folder.py; reference src/main/pipeline_folder.py:5-27):
run the offline pipeline over every video file in a directory, one
`python -m sharkshark_tpu_torch.main.upscaler` per file with frame
skipping off, skipping outputs ('[SS4] <name>.flv') that already exist.
Flags it does not know (--model, --device, ...) pass through to the CLI.

  python -m sharkshark_tpu_torch.main.pipeline_folder --dir videos/ [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

VIDEO_EXTS = (".mp4", ".mkv", ".webm", ".flv", ".ts", ".mov")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="sharkshark_tpu_torch.main.pipeline_folder")
    p.add_argument("--dir", required=True)
    p.add_argument("--fps", type=float, default=24)
    p.add_argument("--lr-level", type=int, default=3)
    p.add_argument("--hr-level", type=int, default=0)
    args, passthrough = p.parse_known_args(argv)

    for name in sorted(os.listdir(args.dir)):
        if not name.lower().endswith(VIDEO_EXTS) or name.startswith("[SS4]"):
            continue
        src = os.path.join(args.dir, name)
        dst = os.path.join(args.dir, f"[SS4] {os.path.splitext(name)[0]}.flv")
        if os.path.exists(dst):
            print(f"skip (exists): {dst}")
            continue
        cmd = [
            sys.executable, "-m", "sharkshark_tpu_torch.main.upscaler",
            "--url", src,
            "--output-file", dst,
            "--fps", str(args.fps),
            "--lr-level", str(args.lr_level),
            "--hr-level", str(args.hr_level),
            "--no-frame-skips",
            *passthrough,
        ]
        print("run:", " ".join(cmd))
        subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
