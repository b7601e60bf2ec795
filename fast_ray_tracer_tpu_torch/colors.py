"""Color-space conversions on the host, float64 numpy over (..., 3) arrays.

The port's copy of the JAX package's colors.py, for the input decode of
scene colors and textures: the reference's formulas (src/color/{rgb,srgb,
xyz,lab}.c) with the same matrices and thresholds. Every conversion runs
in float64 whatever the frame's dtype (the JAX package decodes LAB in
float32 whenever x64 is off). HSL and XYY decode to themselves, as the
reference's empty `hsl_to_rgb` stub and its copying `xyy_to_rgb` do.
"""

from __future__ import annotations

import numpy as np

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


def xyz_to_rgb(xyz) -> np.ndarray:
    return _f64(xyz) @ XYZ_TO_RGB.T


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
