"""Top-level render loop, one device.

Every pixel's usteps x vsteps subpixel samples become rays in one flat
batch, chunked to bound memory: a chunk holds at most
SHADOW_RAYS_PER_CHUNK rays times light samples, since an area or circle
light of S samples makes each level's shadow query S times the level's
rays. Scenes with reflective or refractive materials trace through the
static-bucket wavefront (integrator.trace_bucketed): one probe pass over
up to five sampled chunks measures each level's spawn counts, and one
shared bucket tuple serves the whole render. A chunk whose children still overflow a bucket escalates
the buckets once; if it still overflows, that chunk is re-rendered on the
exact unrolled trace. Each chunk costs one host sync, where its overflow
flag and its colors come back.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.render.camera import (
    build_camera, rays_for_pixels, sample_aperture,
)
from fast_ray_tracer_tpu_torch.render.integrator import (
    build_statics, spawn_counts, trace, trace_bucketed,
)
from fast_ray_tracer_tpu_torch.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.ir import default_device
from fast_ray_tracer_tpu_torch.scene.model import SceneDesc


# the largest (chunk rays) x (light samples) product of a chunk: a
# soft_textured frame of one chunk at this cap peaked at 7.767 GiB of device
# memory on an NVIDIA H100 80GB HBM3 (700.00 W); chip_smoke.py holds that
# peak under its budget (PERF.md, section 5)
SHADOW_RAYS_PER_CHUNK = 1 << 25


def quantize_buckets(counts, margin):
    """Per-level spawn counts -> bucket sizes with `margin` headroom, in
    multiples of 4096 lanes (at least 256)."""
    return tuple(max(256, int(math.ceil(c * margin / 4096)) * 4096)
                 for c in counts)


def render_scene(scene: SceneDesc, dtype=torch.float32,
                 chunk_pixels: int = 8192, device=None,
                 compaction: str = "auto",
                 stats: Optional[dict] = None) -> np.ndarray:
    """Render a scene to an (H, W, 3) float64 numpy canvas (linear,
    pre-encode), on `device` (default: the CUDA card; the CPU only when
    asked for).

    Only deterministic scenes are ported: jittered cameras or lights,
    shaped apertures and photon GI raise NotImplementedError. Chunks are
    cut to SHADOW_RAYS_PER_CHUNK rays times the scene's most light
    samples.
    `compaction="plain"` forces the plain torch compaction (for tests that
    hold the kernels against it). If `stats` is a dict, it receives the
    calibrated `buckets` and the counts of chunks that needed a bucket
    escalation (`escalations`) or the exact fallback (`exact_chunks`)."""
    cfg = scene.config
    cam = scene.camera
    if cfg.photon_count > 0 and (cfg.include_global or cfg.visualize_photon_map
                                 or cfg.visualize_soft_indirect):
        raise NotImplementedError("photon-mapped GI is not ported yet")
    device = default_device(device)
    ir = compile_scene(scene, dtype=dtype, device=device)
    needs_rng = (cam.aperture.jitter
                 or any(info[3] for info in ir.meta.light_info))
    if needs_rng:
        raise NotImplementedError("scenes that need random numbers (jittered "
                                  "cameras or lights) are not ported yet")
    cam_rt = build_camera(cam, dtype=dtype, device=device)
    rt = build_statics(ir, cfg)

    W, H = cam.width, cam.height
    S = cam.usteps * cam.vsteps
    chunk_pixels = min(chunk_pixels, max(
        256, SHADOW_RAYS_PER_CHUNK // (S * ir.meta.max_light_samples)))
    path_length = cfg.di_path_length
    det_table = torch.as_tensor(cmj_points_static(cam.usteps, cam.vsteps)) \
        .to(device=device, dtype=dtype)
    use_bucketed = ir.meta.has_reflective or ir.meta.has_refractive
    if stats is None:
        stats = {}
    stats.update(buckets=None, escalations=0, exact_chunks=0)

    def chunk_rays(px, py):
        n = px.shape[0]
        uv = det_table[None].expand(n, S, 2).reshape(n * S, 2)
        ap = sample_aperture(cam_rt, n * S, dtype, device)
        return rays_for_pixels(cam_rt, px.repeat_interleave(S),
                               py.repeat_interleave(S), uv, ap)

    def avg(triple):
        n = triple.a.shape[0] // S
        a = triple.a.reshape(n, S, 3).mean(1)
        d = triple.d.reshape(n, S, 3).mean(1)
        s = triple.s.reshape(n, S, 3).mean(1)
        return (a + d + s) / 3.0

    def probe_counts(px, py):
        counts = spawn_counts(ir, rt, *chunk_rays(px, py), path_length,
                              compaction=compaction)
        return torch.stack(counts).tolist() if counts else []

    def render_chunk(px, py, buckets):
        orig, dirs = chunk_rays(px, py)
        if not use_bucketed:
            return avg(trace(ir, rt, orig, dirs, path_length)), False
        tr, ovf = trace_bucketed(ir, rt, orig, dirs, path_length,
                                 list(buckets), compaction=compaction)
        return avg(tr), bool(ovf)

    total = W * H
    n_chunks = math.ceil(total / chunk_pixels)

    def chunk_arrays(c):
        # pixel ids of chunk c, made on the device; the tail chunk is padded
        # to the fixed chunk size with pixel (0, 0), cut off afterwards
        idx = torch.arange(c * chunk_pixels, (c + 1) * chunk_pixels,
                           device=device)
        idx = torch.where(idx < total, idx, 0)
        return idx % W, idx // W

    buckets = ()
    if use_bucketed:
        # ONE calibration for the whole render: max per-level spawn counts
        # over five sampled chunks (the top of the image is often
        # background and alone would under-size every bucket), 1.5x margin
        samples = sorted({0, n_chunks // 4, n_chunks // 2,
                          (3 * n_chunks) // 4, n_chunks - 1})
        counts = [probe_counts(*chunk_arrays(c)) for c in samples]
        buckets = quantize_buckets([max(v) for v in zip(*counts)], 1.5)
        stats["buckets"] = buckets

    out = np.zeros((total, 3), dtype=np.float64)
    for c in range(n_chunks):
        lo = c * chunk_pixels
        hi = min(lo + chunk_pixels, total)
        px, py = chunk_arrays(c)
        res, ovf = render_chunk(px, py, buckets)
        if ovf:
            # exact per-level counts for THIS chunk; the escalated buckets
            # serve the rest of the render
            esc = quantize_buckets(probe_counts(px, py), 1.2)
            buckets = tuple(max(a, b) for a, b in zip(buckets, esc))
            stats["buckets"] = buckets
            stats["escalations"] += 1
            print(f"bucket overflow: recalibrated to {buckets}", flush=True)
            res, ovf = render_chunk(px, py, buckets)
        if ovf:
            # probe ceiling exceeded (spawns > 3x primary): never silent —
            # the unrolled exact path re-renders the chunk
            stats["exact_chunks"] += 1
            print(f"bucket overflow persists (buckets={buckets}): chunk "
                  "re-rendered on the exact unrolled path", flush=True)
            res = avg(trace(ir, rt, *chunk_rays(px, py), path_length))
        out[lo:hi] = res[: hi - lo].cpu().double().numpy()
    return out.reshape(H, W, 3)
