"""Camera model and batched primary-ray generation.

Matches src/renderer/camera.c + ray_for_pixel (renderer.c:95-129): the
canvas plane sits at z = -canvas_distance in camera space with
half_view = canvas_distance * tan(fov/2); pixel (px, py) with subpixel
jitter maps to world_x = half_width - (px + jx) * pixel_size (note the
x flip), the ray origin is a point on the aperture disk scaled by
aperture.size, both mapped through the camera's inverse view transform.

This slice has the point aperture only (and the hexagonal, pentagonal and
octagonal enum values, which the reference also treats as a point);
the shaped, sampled apertures come with the stochastic slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.ops.vec import dot3, xform_points
from fast_ray_tracer_tpu_torch.scene.ir import default_device
from fast_ray_tracer_tpu_torch.scene.model import CameraDesc

POINT_LIKE_APERTURES = ("POINT_APERTURE", "HEXAGONAL_APERTURE",
                        "PENTAGONAL_APERTURE", "OCTAGONAL_APERTURE")


class CameraRT(NamedTuple):
    inv: torch.Tensor         # (4,4) inverse view transform
    pixel_size: float
    half_width: float
    half_height: float
    canvas_distance: float
    aperture_kind: str
    aperture_size: float
    aperture_params: tuple


def view_transform_np(frm, to, up):
    frm = np.asarray(frm, np.float64)
    to = np.asarray(to, np.float64)
    up = np.asarray(up, np.float64)
    forward = to - frm
    forward = forward / np.linalg.norm(forward)
    upn = up / np.linalg.norm(up)
    left = np.cross(forward, upn)
    true_up = np.cross(left, forward)
    orientation = np.eye(4)
    orientation[0, :3] = left
    orientation[1, :3] = true_up
    orientation[2, :3] = -forward
    m = np.eye(4)
    m[:3, 3] = -frm
    return orientation @ m


def build_camera(cam: CameraDesc, dtype=torch.float32,
                 device=None) -> CameraRT:
    """The camera's runtime constants; `inv` on `device` (default: the
    CUDA card)."""
    half_view = cam.focal_length * math.tan(cam.field_of_view * 0.5)
    aspect = cam.width / cam.height
    if aspect >= 1.0:
        half_width, half_height = half_view, half_view / aspect
    else:
        half_width, half_height = half_view * aspect, half_view
    pixel_size = half_width * 2.0 / cam.width
    inv = np.linalg.inv(view_transform_np(cam.frm, cam.to, cam.up))
    return CameraRT(
        inv=torch.as_tensor(inv).to(device=default_device(device),
                                    dtype=dtype),
        pixel_size=pixel_size,
        half_width=half_width, half_height=half_height,
        canvas_distance=cam.focal_length,
        aperture_kind=cam.aperture.kind, aperture_size=cam.aperture.size,
        aperture_params=cam.aperture.params)


def sample_aperture(rt: CameraRT, n: int, dtype, device):
    """(n, 2) aperture offsets: the center, for the point-like apertures."""
    if rt.aperture_kind not in POINT_LIKE_APERTURES:
        raise NotImplementedError(
            f"{rt.aperture_kind} needs random numbers; not ported yet")
    return torch.zeros((n, 2), dtype=dtype, device=device)


def rays_for_pixels(rt: CameraRT, px, py, jitter_uv, aperture_xy):
    """px/py: (n,) pixel indices; jitter_uv: (n,2) subpixel offsets in [0,1);
    aperture_xy: (n,2). Returns (origins (n,3), directions (n,3))."""
    dtype = jitter_uv.dtype
    xoffset = (px.to(dtype) + jitter_uv[:, 0]) * rt.pixel_size
    yoffset = (py.to(dtype) + jitter_uv[:, 1]) * rt.pixel_size
    world_x = rt.half_width - xoffset
    world_y = rt.half_height - yoffset
    pix = torch.stack([world_x, world_y,
                       torch.full_like(world_x, -rt.canvas_distance)], -1)
    pixel = xform_points(rt.inv, pix)
    ap = aperture_xy * rt.aperture_size
    origin_cam = torch.cat([ap, torch.zeros_like(ap[:, :1])], -1)
    origin = xform_points(rt.inv, origin_cam)
    v = pixel - origin
    direction = v / torch.sqrt(dot3(v, v)).clamp(min=1e-30)[:, None]
    return origin, direction
