"""The source's video content, made from the seed.

In the manner of `chip_smoke.py::make_frames` (a smooth seeded scene
that pans 3 px right and 1 px down a frame, with fresh sensor noise on
every frame), made so that the source never paces an unpaced cell:

- the scene is periodic (a coarse random grid, bicubic-upsampled 16x
  with wrap-around), so the pan runs on for as long as a window lasts
  with no cut;
- the scene is stored as uint8 in [28, 228] and the noise (sigma 6,
  cut at +-27) as int8, so a frame is one wrapping uint8 add of two
  slices, which never wraps: about a millisecond a 720p frame;
- each frame's noise is a slice of one of a bank of noise fields at an
  offset drawn from the seed, so every frame has noise of its own.

The same seed gives the same frames, in the source process and in the
reference alike (`Scene.frame`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Scene"]

_CELL = 16        # px of the scene per coarse grid cell
_NOISE_CUT = 27   # |noise| <= 27 keeps [28, 228] + noise inside [1, 255]
_BANK = 4         # noise fields in the bank
_MARGIN = 64      # noise field size beyond the frame, for the offsets
_CHOICES = 1 << 16  # frames with noise offsets of their own; the pattern repeats after


class Scene:
    """Frames of shape (h, w, 3) uint8: frame i is the scene (of period
    2h x 2w) at offset (i * pan_y, i * pan_x), plus noise field k_i at
    (dy_i, dx_i)."""

    def __init__(self, seed: int, h: int, w: int, *, pan: tuple[int, int], sigma: float) -> None:
        self.h, self.w = h, w
        self.pan = pan
        ph, pw = 2 * h, 2 * w
        self.period = (ph, pw)
        rng = np.random.default_rng(seed)
        coarse = rng.random((ph // _CELL, pw // _CELL, 3), dtype=np.float32)
        scene = _periodic_bicubic(coarse, _CELL)
        scene_u8 = np.clip(np.rint(scene * 200.0 + 28.0), 28, 228).astype(np.uint8)
        # tiled by one frame on each axis, so every view is a plain slice
        self.tiled = np.pad(scene_u8, ((0, h), (0, w), (0, 0)), mode="wrap")
        noise = np.rint(rng.standard_normal((_BANK, h + _MARGIN, w + _MARGIN, 3), dtype=np.float32) * sigma)
        self.bank = np.clip(noise, -_NOISE_CUT, _NOISE_CUT).astype(np.int8).view(np.uint8)
        self.choice = np.stack([rng.integers(0, _BANK, _CHOICES), rng.integers(0, _MARGIN, _CHOICES),
                                rng.integers(0, _MARGIN, _CHOICES)], axis=1)

    def frame(self, i: int, out: np.ndarray | None = None) -> np.ndarray:
        """Frame i, written into `out` (h, w, 3) uint8 where given."""
        h, w = self.h, self.w
        y = (i * self.pan[0]) % self.period[0]
        x = (i * self.pan[1]) % self.period[1]
        k, dy, dx = (int(v) for v in self.choice[i % len(self.choice)])
        view = self.tiled[y:y + h, x:x + w]
        noise = self.bank[k, dy:dy + h, dx:dx + w]
        if out is None:
            out = np.empty((h, w, 3), np.uint8)
        np.add(view, noise, out=out)  # wraps mod 256: exact, as nothing leaves [1, 255]
        return out

    def frames(self, idx) -> np.ndarray:
        """The frames at indices `idx`, stacked (n, h, w, 3)."""
        idx = list(idx)
        out = np.empty((len(idx), self.h, self.w, 3), np.uint8)
        for j, i in enumerate(idx):
            self.frame(i, out[j])
        return out


def _periodic_bicubic(coarse: np.ndarray, factor: int) -> np.ndarray:
    """Bicubic (a = -0.75, half-pixel centres) upsampling of a grid that
    wraps around on both axes: (gh, gw, c) -> (gh * factor, gw * factor, c)."""
    out = coarse
    for axis in (0, 1):
        n = out.shape[axis]
        src = (np.arange(n * factor) + 0.5) / factor - 0.5
        i0 = np.floor(src).astype(np.int64)
        t = src - i0
        acc = None
        for k in range(-1, 3):
            d = np.abs(k - t)
            wk = np.where(d <= 1, (1.25 * d - 2.25) * d * d + 1,
                          np.where(d < 2, ((-0.75 * d + 3.75) * d - 6) * d + 3, 0.0)).astype(np.float32)
            tap = np.take(out, (i0 + k) % n, axis=axis)
            shape = [1, 1, 1]
            shape[axis] = -1
            term = tap * wk.reshape(shape)
            acc = term if acc is None else acc + term
        out = acc
    return out
