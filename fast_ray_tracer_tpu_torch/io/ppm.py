"""Canvas output: 16-bit binary PPM (P6).

Host-side numpy, as in the JAX package, reproducing the reference encoder
bit for bit (src/libs/canvas/canvas.c:150-301): two analysis passes compute
per-channel `rgb_max` over the raw canvas and `srgb_max` over
srgb(canvas/rgb_max); the encode pass then either L1-clamps each pixel to
sqrt(3) (use_scaling) or clamps channels to [0,1], sRGB-encodes, and
quantizes with floor(srgb * 65535/srgb_max), saturating to 65535 above
srgb_max. PNG output and texture reading come with later slices.
"""

from __future__ import annotations

import numpy as np

from fast_ray_tracer_tpu_torch.constants import SQRT3


def _rgb_to_srgb(rgb: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore"):
        return np.where(rgb < 0.0031308, rgb * 12.92,
                        1.055 * np.power(np.maximum(rgb, 0.0), 1.0 / 2.4) - 0.055)


def construct_ppm(canvas: np.ndarray, use_scaling: bool = True) -> bytes:
    """Encode an (H, W, 3) float canvas to 16-bit binary P6 bytes."""
    c = np.asarray(canvas, dtype=np.float64)
    h, w = c.shape[:2]
    header = f"P6\n{w} {h}\n65535\n".encode()

    rgb_max = c.reshape(-1, 3).max(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        normalized = c / rgb_max
    srgb_max = np.nanmax(_rgb_to_srgb(normalized).reshape(-1, 3), axis=0)
    inverse = 65535.0 / srgb_max

    px = c.copy()
    if use_scaling:
        l1 = px.sum(axis=-1, keepdims=True)
        scale = np.where(l1 > SQRT3, SQRT3 / np.where(l1 == 0.0, 1.0, l1), 1.0)
        px = px * scale
    else:
        px = np.clip(px, 0.0, 1.0)
    srgb = _rgb_to_srgb(px)

    scaled = np.floor(srgb * inverse)
    scaled = np.where(srgb > srgb_max, 65535.0, scaled)
    scaled = np.where(srgb < 0.0, 0.0, scaled)
    data = scaled.astype(np.uint16).astype(">u2").tobytes()
    return header + data + b"\n"


def write_ppm(canvas, path: str, use_scaling: bool = True) -> None:
    """Write `<path>.ppm` like the reference's write_ppm_file (canvas.c:303)."""
    with open(str(path) + ".ppm", "wb") as f:
        f.write(construct_ppm(np.asarray(canvas), use_scaling))
