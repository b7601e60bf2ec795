"""Color-space conversions on the host, float64 numpy over (..., 3) arrays.

The port's copy of the JAX package's colors.py, for the input decode of
scene colors and textures and for the CIE-Lab lightness that apportions
photons among lights: the reference's formulas (src/color/{rgb,srgb,
xyz,lab}.c) with the same matrices and thresholds. Every conversion runs
in float64 whatever the frame's dtype (the JAX package decodes LAB, and
computes the lightness, in float32 whenever x64 is off). HSL and XYY decode to themselves, as the
reference's empty `hsl_to_rgb` stub and its copying `xyy_to_rgb` do.
"""

from __future__ import annotations

import numpy as np

RGB_TO_XYZ = np.array([
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227],
])

XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875992, 0.041556],
    [0.055648, -0.204043, 1.057311],
])

# the reference's Lab white point (src/color/color.c `tristimulus`)
TRISTIMULUS = np.array([0.95047, 1.0, 1.08883])


def _f64(c) -> np.ndarray:
    return np.asarray(c, dtype=np.float64)


def srgb_to_rgb(srgb) -> np.ndarray:
    """sRGB decode (src/color/srgb.c:17-27)."""
    srgb = _f64(srgb)
    return np.where(srgb <= 0.04045, srgb / 12.92,
                    np.power((srgb + 0.055) / 1.055, 2.4))


def rgb_to_srgb(rgb) -> np.ndarray:
    """Linear to sRGB (src/color/rgb.c:69-77), the encode of the PPM and
    PNG writers; negative values take the linear branch and NaN stays
    NaN, as in the C code."""
    rgb = _f64(rgb)
    with np.errstate(invalid="ignore"):
        return np.where(rgb < 0.0031308, rgb * 12.92,
                        1.055 * np.power(np.maximum(rgb, 0.0), 1.0 / 2.4)
                        - 0.055)


def rgb_to_xyz(rgb) -> np.ndarray:
    return _f64(rgb) @ RGB_TO_XYZ.T


def xyz_to_rgb(xyz) -> np.ndarray:
    return _f64(xyz) @ XYZ_TO_RGB.T


def xyz_to_lab(xyz) -> np.ndarray:
    """src/color/srgb.c xyz_to_lab (the same thresholds)."""
    n = _f64(xyz) / TRISTIMULUS
    f = np.where(n > 0.008856, np.cbrt(np.abs(n)), 7.787 * n + 16.0 / 116.0)
    ny = n[..., 1]
    lum = np.where(ny > 0.008856, 116.0 * np.cbrt(np.abs(ny)) - 16.0,
                   903.3 * ny)
    return np.stack([lum, 500.0 * (f[..., 0] - f[..., 1]),
                     200.0 * (f[..., 1] - f[..., 2])], axis=-1)


def rgb_to_lab(rgb) -> np.ndarray:
    return xyz_to_lab(rgb_to_xyz(rgb))


def lab_to_xyz(lab) -> np.ndarray:
    lab = _f64(lab)
    p = (lab[..., 0] + 16.0) / 116.0
    return np.stack([
        TRISTIMULUS[0] * (p + lab[..., 1] / 500.0) ** 3,
        TRISTIMULUS[1] * p ** 3,
        TRISTIMULUS[2] * (p - lab[..., 2] / 200.0) ** 3,
    ], axis=-1)


def lab_to_rgb(lab) -> np.ndarray:
    return xyz_to_rgb(lab_to_xyz(lab))


def identity(c) -> np.ndarray:
    return _f64(c)


# input decode keyed by the YAML `color-space` value: applied to material
# and pattern colors and to Ka/Kd textures as they are read
# (yaml_parser/config.py:72-99)
INPUT_DECODE = {
    "SRGB": srgb_to_rgb,
    "RGB": identity,
    "HSL": identity,
    "XYZ": xyz_to_rgb,
    "XYY": identity,
    "LAB": lab_to_rgb,
}
