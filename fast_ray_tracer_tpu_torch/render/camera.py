"""Camera model and batched primary-ray generation.

Matches src/renderer/camera.c + ray_for_pixel (renderer.c:95-129): the
canvas plane sits at z = -canvas_distance in camera space with
half_view = canvas_distance * tan(fov/2); pixel (px, py) with subpixel
jitter maps to world_x = half_width - (px + jx) * pixel_size (note the
x flip), the ray origin is a point on the aperture disk scaled by
aperture.size, both mapped through the camera's inverse view transform.

Shaped apertures (camera.c:11-90) are rejection samplers over the unit
square, bounded at APERTURE_TRIES tries whose uniforms the caller passes
(`draw_aperture` draws them from an RNG node); point apertures are the
deterministic center. Hexagonal, pentagonal and octagonal enum values
fall back to the point, like the C switch (camera.c:193-204).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.ops.vec import dot3, xform_points
from fast_ray_tracer_tpu_torch.scene.ir import default_device
from fast_ray_tracer_tpu_torch.scene.model import CameraDesc
from fast_ray_tracer_tpu_torch.utils.profiling import host_sync

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
    with host_sync("upload"):
        inv = torch.as_tensor(inv).to(device=default_device(device),
                                      dtype=dtype)
    return CameraRT(
        inv=inv,
        pixel_size=pixel_size,
        half_width=half_width, half_height=half_height,
        canvas_distance=cam.focal_length,
        aperture_kind=cam.aperture.kind, aperture_size=cam.aperture.size,
        aperture_params=cam.aperture.params)


# rejection-sampler tries per ray: the first accepted try wins, the last
# one when none is
APERTURE_TRIES = 32


def sample_aperture(rt: CameraRT, n: int, dtype, device, xs=None):
    """(n, 2) aperture offsets, about [-0.5, 0.5] before the size scaling:
    the center for the point-like apertures; else from the uniforms `xs`,
    (n, 2) for the square aperture and (APERTURE_TRIES, n, 2) for the
    rejection samplers (circular, doughnut, cross, diamond)."""
    kind = rt.aperture_kind
    if kind in POINT_LIKE_APERTURES:
        return torch.zeros((n, 2), dtype=dtype, device=device)
    if xs is None:
        raise ValueError(f"{kind} needs its uniforms (draw_aperture)")
    if kind == "SQUARE_APERTURE":
        return xs - 0.5
    u = 2.0 * xs[..., 0] - 1.0
    v = 2.0 * xs[..., 1] - 1.0
    p = rt.aperture_params
    if kind == "CIRCULAR_APERTURE":
        ok = u * u + v * v <= p[0]
    elif kind == "DOUGHNUT_APERTURE":
        mag = u * u + v * v
        ok = (mag <= p[0]) & (mag >= p[1])
    elif kind == "CROSS_APERTURE":
        x1, x2, y1, y2 = p
        ok = ((u > x1) & (u <= x2)) | ((v > y1) & (v <= y2))
    elif kind == "DIAMOND_APERTURE":
        b1, b2, b3, b4 = p
        left = (u <= 0) & (-u + b1 <= v) & (v < u + b2)
        # the right half tests the raw uniform, not u (a reference quirk)
        right = (u > 0) & (xs[..., 0] >= 0) & (u + b3 <= v) & (v < -u + b4)
        ok = left | right
    else:
        raise ValueError(f"unknown aperture {kind}")
    # the first accepted try per ray (argmax takes the first maximum); the
    # last try when none is accepted
    first = ok.to(torch.uint8).argmax(0)
    idx = torch.where(ok.any(0), first, APERTURE_TRIES - 1)
    return xs.gather(0, idx[None, :, None].expand(1, n, 2))[0] - 0.5


def draw_aperture(rt: CameraRT, n: int, rng, dtype):
    """sample_aperture's uniforms for n rays from an RNG node (None for the
    point-like apertures, which draw nothing)."""
    kind = rt.aperture_kind
    if kind in POINT_LIKE_APERTURES:
        return None
    if kind == "SQUARE_APERTURE":
        return rng.uniform((n, 2), dtype)
    return rng.uniform((APERTURE_TRIES, n, 2), dtype)


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
