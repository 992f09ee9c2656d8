"""The reference outputs of the two restream paths, worked out again from
the source frames (regenerated from the seed), the weights files and the
service's timeline: which source frame it took at each position.

realesrgan (the CLI's default; upscale/steps.py of the program for the
order of the steps, which this follows):

    lr = frame / 255 (area-resized to the LR size)
    den(d) = BSVD's output at timeline position d, over the clip of
             positions [d - 16, d + 16] (BSVD's temporal reach is 16
             frames each way, so the clip gives the stream's exact
             state), with the noise map 0.05 at position 0 and
             0.1 * rate after, zero frames past the stream's end
    live output at q = post(den(q - 16), lr(q)); drained output at p = post(den(p), lr(p))
    post(d, l) = clamp(sharpen(d, 2e-5)) * 0.8 + 0.2 l -> SRVGG x4 ->
                 bicubic to the output size -> clamp(sharpen(., 7e-5))
                 -> global colour match to l -> clamp -> uint8

egvsr: the FRNet recurrence from the stream's start,

    flow = FNet(lr_q, lr_{q-1}) upsampled bilinear x4 and scaled by 4
    cut = mean |lr_q - lr_{q-1}| > threshold (lr_{-1} = 0)
    hr_q = SRNet(lr_q, s2d(cut ? hr_{q-1} : warp(hr_{q-1}, flow)))   (hr_{-1} = 0)
    output q = uint8(clamp(bicubic(clamp(hr_q), output size)))

Everything in float32 with TF32 off (run.py sets it), in blocks of
frames, after the program's state is freed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import models as m

__all__ = ["Reference"]


def _lr(frames: np.ndarray, size, device) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(device).permute(0, 3, 1, 2).float() / 255.0
    return m.area(x, size)


class Reference:
    """Expected uint8 (H, W, 3) outputs of one configuration."""

    def __init__(self, config: dict, root, device, quant=None) -> None:
        self.cfg = config
        self.device = device
        self.lr_size = tuple(config["lr_shape"])
        self.out_size = tuple(config["output_shape"])
        self.quant = quant
        self.sr = m.Nets(m.load_state_dict(root / config["weights"]), device, quant)
        if config["model"] == "realesrgan":
            self.den = m.Nets(m.load_state_dict(root / config["denoise_weights"]), device, quant)

    # -------------------------------------------------------- realesrgan

    def _denoised(self, scene, timeline: list[int], d: int) -> torch.Tensor:
        """BSVD's output at timeline position d, (1, 3, H, W)."""
        lo, hi = max(0, d - 16), min(len(timeline), d + 17)
        lr = _lr(scene.frames(timeline[lo:hi]), self.lr_size, self.device)
        h, w = lr.shape[-2:]
        hp, wp = -(-h // 4) * 4, -(-w // 4) * 4
        lr = _pad_edge(lr, hp - h, wp - w)
        rate = float(self.cfg["denoise_rate"])
        noise = torch.full((hi - lo, 1, hp, wp), 0.1 * rate, device=self.device)
        if lo == 0:
            noise[0] = 0.05
        out = m.bsvd_clip(self.den, torch.cat([lr, noise], dim=1))
        return out[d - lo: d - lo + 1, :, :h, :w]

    def _post(self, den: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        den = torch.clamp(m.sharpen(den, 2e-5), 0.0, 1.0)
        blend = den * cfg["denoise_opacity"] + (1.0 - cfg["denoise_opacity"]) * lr
        hr = m.bicubic(m.srvgg(self.sr, blend, cfg["srvgg"]["num_conv"], cfg["srvgg"]["upscale"]), self.out_size)
        hr = torch.clamp(m.sharpen(hr, 7e-5), 0.0, 1.0)
        hr = torch.clamp(m.global_color_match(hr, lr), 0.0, 1.0)
        return m.to_uint8(hr)

    def _realesrgan(self, scene, timeline, outputs) -> list[np.ndarray]:
        res = []
        for o in outputs:
            den = self._denoised(scene, timeline, o.den)
            lr = _lr(scene.frames([o.lr]), self.lr_size, self.device)
            res.append(self._post(den, lr)[0].permute(1, 2, 0).cpu().numpy())
        return res

    # ------------------------------------------------------------ egvsr

    def _egvsr(self, scene, timeline, outputs) -> list[np.ndarray]:
        cfg = self.cfg
        want = {o.position: i for i, o in enumerate(outputs)}
        res: list = [None] * len(outputs)
        last = max(want)
        h, w = self.lr_size
        lr_prev = torch.zeros((1, 3, h, w), device=self.device)
        hr = torch.zeros((1, 3, 4 * h, 4 * w), device=self.device)
        block = 16
        for b0 in range(0, last + 1, block):
            idx = timeline[b0: min(last + 1, b0 + block)]
            lrs = _lr(scene.frames(idx), self.lr_size, self.device)
            prevs = torch.cat([lr_prev, lrs[:-1]])
            flows = m.fnet(self.sr, lrs, prevs)
            flows = torch.nn.functional.interpolate(flows, scale_factor=4, mode="bilinear",
                                                    align_corners=False) * 4.0
            cuts = (lrs - prevs).abs().flatten(1).mean(dim=1) > cfg["cut_threshold"]
            for j in range(len(idx)):
                q = b0 + j
                prev = hr if bool(cuts[j]) else m.backward_warp(hr, flows[j: j + 1])
                hr = m.srnet(self.sr, lrs[j: j + 1], m.space_to_depth(prev, 4), cfg["frnet"]["nb"])
                if q in want:
                    out = m.to_uint8(m.bicubic(torch.clamp(hr, 0.0, 1.0), self.out_size))
                    res[want[q]] = out[0].permute(1, 2, 0).cpu().numpy()
            lr_prev = lrs[-1:]
        return res

    def outputs(self, scene, timeline: list[int], outputs) -> list[np.ndarray]:
        """The expected frames of `outputs` (accounting.Output), in order."""
        with torch.no_grad():
            if self.cfg["model"] == "realesrgan":
                return self._realesrgan(scene, timeline, outputs)
            return self._egvsr(scene, timeline, outputs)


def _pad_edge(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    if not (ph or pw):
        return x
    return torch.nn.functional.pad(x, (0, pw, 0, ph), mode="replicate")
