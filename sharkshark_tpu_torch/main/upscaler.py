"""Live-pipeline CLI of the PyTorch port.

    python -m sharkshark_tpu_torch.main.upscaler --url <twitch|file> [--model egvsr] [--device cpu]

The JAX package's flags (reference src/main/upscaler.py:5-42: --quality
--fps --denoise-rate --hr-level --lr-level --audio-queue --output-file
--no-frame-skips, plus --model, --no-denoise, --weights*, --batch-size,
--pix-fmt, --reconnects, --mesh), and two of its own: --device (default
cuda; cpu runs the plain PyTorch path) and --no-overlay (no text
overlays, so the stream layer never needs cv2).  --model takes
'realesrgan' (SRVGG with the BSVD denoiser), 'fsrcnn', 'egvsr' or any
model zoo name (models/zoo.py); --mesh is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sharkshark_tpu_torch.main.upscaler",
        description="Real-time live-stream AI upscaler (PyTorch/CUDA)",
    )
    p.add_argument("--url", required=True, help="twitch URL or local file")
    p.add_argument("--quality", default="1080p60", help="source stream quality")
    p.add_argument("--fps", type=float, default=24)
    p.add_argument("--denoise-rate", type=float, default=0.75)
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--hr-level", type=int, default=0, choices=[0, 1, 2],
                   help="output: 0=1440p 1=1800p 2=2160p")
    p.add_argument("--lr-level", type=int, default=3, choices=range(6),
                   help="processing: 0=360p ... 5=1080p")
    p.add_argument("--audio-queue", type=int, default=0,
                   help="delay audio by N batches for A/V sync")
    p.add_argument("--output-file", default="rtmp://127.0.0.1:1935/live",
                   help="RTMP URL or output file path")
    p.add_argument("--no-frame-skips", action="store_true",
                   help="block instead of dropping frames (offline mode)")
    p.add_argument("--model", default="realesrgan",
                   help="'realesrgan' (production SRVGG), 'fsrcnn', "
                        "'egvsr', or any model-zoo entry name "
                        "(e.g. RealESRGAN_x4plus, realesr-animevideov3)")
    p.add_argument("--weights", default=None, help="SR model .pth path")
    p.add_argument("--weights-wdn", default=None,
                   help="denoise-variant .pth for DNI blending")
    p.add_argument("--denoise-weights", default=None, help="BSVD .pth path")
    p.add_argument("--batch-size", type=int, default=None,
                   help="upscaler micro-batch (default min(4, fps); 8 = "
                        "denoise throughput mode, +1 capture window latency)")
    p.add_argument("--pix-fmt", default="rgb24", choices=["rgb24", "yuv420p"],
                   help="encoder feed format; yuv420p = device-side "
                        "colorspace conversion")
    p.add_argument("--reconnects", type=int, default=0,
                   help="rebuild the stream source up to N times on EOF")
    p.add_argument("--mesh", default=None, metavar="DATA,SPATIAL",
                   help="multi-device mesh: not ported yet")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the upscaler runs (cpu: the plain PyTorch path)")
    p.add_argument("--no-overlay", action="store_true",
                   help="no text overlays on the captured and streamed frames")
    return p


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    from ..models.zoo import ZOO

    known = {"realesrgan", "fsrcnn", "egvsr"} | set(ZOO)
    if args.model not in known:
        parser.error(f"--model {args.model!r} unknown; choose from {sorted(known)}")
    if args.mesh:
        parser.error("--mesh is not ported to the PyTorch port yet (ROADMAP.md: multi-device)")

    from ..pipeline import UpscalePipeline
    from ..utils import resolve_device

    resolve_device(args.device)
    kwargs = {}
    if args.model == "egvsr":
        from ..upscale.levels import HR_LEVELS
        from ..upscale.service import EgvsrUpscalerService

        kwargs["upscaler"] = EgvsrUpscalerService(
            lr_level=args.lr_level,
            output_shape=HR_LEVELS[args.hr_level],
            weights=args.weights,
            pix_fmt=args.pix_fmt,
            device=args.device,
        )
    else:
        kwargs.update(
            upscaler_model=args.model,
            weights=args.weights,
            weights_wdn=args.weights_wdn,
            denoise_weights=args.denoise_weights,
        )

    if args.reconnects:
        from ..stream import Recoder

        kwargs["recoder"] = Recoder(
            url=args.url,
            batch_sec=1,
            fps=args.fps,
            quality=args.quality,
            audio_skip=args.audio_queue,
            max_reconnects=args.reconnects,
            overlay=not args.no_overlay,
        )

    pipeline = UpscalePipeline(
        url=args.url,
        fps=args.fps,
        quality=args.quality,
        frame_skips=not args.no_frame_skips,
        output_file=args.output_file,
        lr_level=args.lr_level,
        hr_level=args.hr_level,
        denoising=not args.no_denoise,
        denoise_rate=args.denoise_rate,
        pix_fmt=args.pix_fmt,
        audio_skip=args.audio_queue,
        batch_size=args.batch_size,
        device=args.device,
        overlay=not args.no_overlay,
        **kwargs,
    )
    pipeline.start()
    try:
        pipeline.join()
    except KeyboardInterrupt:
        pipeline.stop()
        return
    # a stage that died forwarded EOF so that join() returned: report it
    for stage in (pipeline.recoder, pipeline.upscaler, pipeline.streamer):
        stage.check_proc()


if __name__ == "__main__":
    main()
