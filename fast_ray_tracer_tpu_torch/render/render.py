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
flag and its colors come back. With `checkpoint_path` the canvas is
snapshotted every few chunks, and a render resumes from its snapshot.

`pixel_colors` is the differentiable core that the chunk loop and the
training step (parallel/train.py) share: rays for pixel ids, the trace,
the per-pixel average and (A + D + S) / 3, plus the trace's overflow
flag.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.parallel.checkpoint import (
    load_render_progress, save_render_progress,
)
from fast_ray_tracer_tpu_torch.render.camera import (
    build_camera, rays_for_pixels, sample_aperture,
)
from fast_ray_tracer_tpu_torch.render.integrator import (
    build_statics, spawn_counts, trace, trace_bucketed,
)
from fast_ray_tracer_tpu_torch.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR, default_device
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


def needs_rng(ir: SceneIR) -> bool:
    """Whether the scene's lights need random numbers (jittered lights)."""
    return any(info[3] for info in ir.meta.light_info)


def pixel_colors(ir: SceneIR, rt, cam_rt, px, py, uv, ap, n_samples: int,
                 path_length: int, remat=False, buckets=None,
                 compaction: str = "auto"):
    """Pixel ids (with subpixel uv and aperture offsets), each repeated
    n_samples times in a row -> ((n_pixels, 3) linear colors, overflow).

    The differentiable render core: per-sample trace, per-pixel average,
    (A + D + S) / 3 (renderer.c:174-230). `buckets` (a per-level size
    tuple) routes through the static-bucket wavefront, `None` through
    the 2^depth unrolled trace. `overflow` is a 0-d bool tensor on the
    device: True when a level spawned more children than its bucket holds
    and rays were dropped (always False unrolled). Nothing here syncs or
    raises on it; callers check it. Under autograd the bucketed branch
    keeps the spawn value gates on (see trace_bucketed). `remat`
    checkpoints each wavefront level (integrator._make_level_fn).

    Raises NotImplementedError for jittered lights (they need random
    numbers) and for clustered meshes when a float table requires grad:
    the mesh kernels have no backward, so the card would drop gradients
    that the CPU's plain mesh path computes."""
    if needs_rng(ir):
        raise NotImplementedError("scenes that need random numbers "
                                  "(jittered lights) are not ported yet")
    if ir.meta.use_clusters and torch.is_grad_enabled() and any(
            t.requires_grad for t in ir.float_tables().values()):
        raise NotImplementedError("gradients through clustered meshes are "
                                  "not ported yet")
    orig, dirs = rays_for_pixels(cam_rt, px, py, uv, ap)
    if buckets is None:
        triple = trace(ir, rt, orig, dirs, path_length, remat=remat)
        overflow = torch.zeros((), dtype=torch.bool, device=orig.device)
    else:
        triple, overflow = trace_bucketed(
            ir, rt, orig, dirs, path_length, list(buckets),
            compaction=compaction, remat=remat)
    n = px.shape[0] // n_samples
    a = triple.a.reshape(n, n_samples, 3).mean(1)
    d = triple.d.reshape(n, n_samples, 3).mean(1)
    s = triple.s.reshape(n, n_samples, 3).mean(1)
    return (a + d + s) / 3.0, overflow


def render_scene(scene: SceneDesc, dtype=torch.float32,
                 chunk_pixels: int = 8192, device=None,
                 compaction: str = "auto",
                 stats: Optional[dict] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 8) -> np.ndarray:
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
    escalation (`escalations`) or the exact fallback (`exact_chunks`).
    With `checkpoint_path`, the canvas and the count of finished chunks
    are written there every `checkpoint_every` chunks and after the last
    one; a render that finds a snapshot of the same chunking there
    resumes after its last finished chunk."""
    cfg = scene.config
    cam = scene.camera
    if cfg.photon_count > 0 and (cfg.include_global or cfg.visualize_photon_map
                                 or cfg.visualize_soft_indirect):
        raise NotImplementedError("photon-mapped GI is not ported yet")
    device = default_device(device)
    ir = compile_scene(scene, dtype=dtype, device=device)
    if cam.aperture.jitter or needs_rng(ir):
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

    def sample_args(px, py):
        n = px.shape[0]
        uv = det_table[None].expand(n, S, 2).reshape(n * S, 2)
        ap = sample_aperture(cam_rt, n * S, dtype, device)
        return px.repeat_interleave(S), py.repeat_interleave(S), uv, ap

    def probe_counts(px, py):
        counts = spawn_counts(ir, rt, *rays_for_pixels(cam_rt,
                                                       *sample_args(px, py)),
                              path_length, compaction=compaction)
        return torch.stack(counts).tolist() if counts else []

    def render_chunk(px, py, buckets):
        res, ovf = pixel_colors(ir, rt, cam_rt, *sample_args(px, py), S,
                                path_length, buckets=buckets,
                                compaction=compaction)
        return res, bool(ovf)

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
    start_chunk = 0
    if checkpoint_path is not None:
        snap = load_render_progress(checkpoint_path)
        if snap is not None and snap["total_chunks"] == n_chunks \
                and snap["canvas"].shape == (total, 3):
            out = snap["canvas"]
            start_chunk = snap["chunks_done"]
    for c in range(start_chunk, n_chunks):
        lo = c * chunk_pixels
        hi = min(lo + chunk_pixels, total)
        px, py = chunk_arrays(c)
        res, ovf = render_chunk(px, py, buckets if use_bucketed else None)
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
            res, _ = render_chunk(px, py, None)
        out[lo:hi] = res[: hi - lo].cpu().double().numpy()
        if checkpoint_path is not None and (
                (c + 1) % checkpoint_every == 0 or c + 1 == n_chunks):
            save_render_progress(checkpoint_path, out, c + 1, n_chunks)
    return out.reshape(H, W, 3)
