"""Top-level render loop, on one device or many.

Every pixel's usteps x vsteps subpixel samples become rays in one flat
batch, chunked to bound memory: a chunk holds at most
SHADOW_RAYS_PER_CHUNK rays times light samples, since an area or circle
light of S samples makes each level's shadow query S times the level's
rays. Scenes with reflective or refractive materials trace through the
static-bucket wavefront (integrator.trace_bucketed): one probe pass over
up to five sampled chunks measures each level's spawn counts, and one
shared bucket tuple serves the whole render. A chunk whose children still overflow a bucket escalates
the buckets once; if it still overflows, that chunk is re-rendered on the
exact unrolled trace. Each chunk costs two host syncs: its overflow flag
and its colors come back. With `checkpoint_path` the canvas is
snapshotted every few chunks, and a render resumes from its snapshot.

Scenes that need random numbers (camera jitter, a shaped aperture, a
jittered light, photon GI) draw them from one RNG tree rooted at the
render's `seed` (sampling/rng.py): chunk c folds in c; its camera draws
come from that node (split two ways under camera jitter), its trace from
fold(1), the photon pass from the root's fold(12345) — the JAX package's
key tree. Photon GI runs a photon pass before the chunk loop
(render/photon.py) and hangs its estimate on RenderStatics.gi_hook.

`pixel_colors` is the differentiable core that the chunk loop and the
training step (parallel/train.py) share: rays for pixel ids, the trace,
the per-pixel average and (A + D + S) / 3, plus the trace's overflow
flag.

One chunk loop serves one device and many. With a `mesh`
(parallel/mesh.py: one process per device over torch.distributed) every
rank calls `render_scene` with the same arguments: each chunk's pixels
split into contiguous equal shards, rank r traces shard r from the RNG
node root.fold(c).fold(r) (the JAX package's `local_rays` folds the
device index the same way), the probe counts and overflow flags are
reduced with MAX so every rank escalates on the same chunks, and the
chunk's colors are all-gathered, so every rank returns the whole canvas.
The photon pass runs whole on every rank. Per-pixel arithmetic is
unchanged, so a deterministic frame is the same canvas at any world
size. Without a mesh no collective runs.

The bucket calibration of a single-device render is kept on disk
(`frt_buckets.json` in $FRT_COMPILE_CACHE, default ~/.cache/frt_torch),
keyed by everything spawn counts depend on: a repeat render skips the
probe. A stale entry costs only the escalation, which rewrites it.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.ops import mesh
from fast_ray_tracer_tpu_torch.parallel.checkpoint import (
    load_render_progress, save_render_progress,
)
from fast_ray_tracer_tpu_torch.parallel.mesh import (
    PixelMesh, all_reduce_, gather_rows,
)
from fast_ray_tracer_tpu_torch.render import photon
from fast_ray_tracer_tpu_torch.render.camera import (
    POINT_LIKE_APERTURES, build_camera, draw_aperture, rays_for_pixels,
    sample_aperture,
)
from fast_ray_tracer_tpu_torch.render.integrator import (
    build_statics, spawn_counts, trace, trace_bucketed,
)
from fast_ray_tracer_tpu_torch.sampling.cmj import (
    cmj_points_batched, cmj_points_static, draw_cmj_batched,
)
from fast_ray_tracer_tpu_torch.sampling.rng import RNG
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR, default_device
from fast_ray_tracer_tpu_torch.scene.model import SceneDesc
from fast_ray_tracer_tpu_torch.utils.profiling import (
    PhaseTimer, add_sink, host_sync, span, timed_span, unit,
)


# the largest (chunk rays) x (light samples + final-gather rays) product
# of a chunk: a soft_textured frame of one chunk at this cap peaked at
# 7.767 GiB of device memory on an NVIDIA H100 80GB HBM3 (700.00 W);
# chip_smoke.py holds that peak under its budget (PERF.md, section 5)
SHADOW_RAYS_PER_CHUNK = 1 << 25
# the photon pass's root: the render tree's fold(PHOTON_FOLD)
PHOTON_FOLD = 12345


# tables larger than this are fingerprinted by a strided sample and their
# ends, not hashed whole (a 141,312-triangle mesh's tables are ~10 MB)
_HASH_WHOLE_BYTES = 1 << 20


def _bucket_cache_path() -> str:
    return os.path.join(os.environ.get(
        "FRT_COMPILE_CACHE", os.path.expanduser("~/.cache/frt_torch")),
        "frt_buckets.json")


def _bucket_cache_key(ir: SceneIR, cfg, cam, chunk_pixels, dtype,
                      path_length) -> str:
    """A hash of everything the spawn counts depend on: the scene's static
    structure and config, the camera (the frame's size, its samples a
    pixel, its aperture and pose), the chunk, the dtype, the depth, and a
    fingerprint of every table (its shape and dtype, and its bytes, or
    for a large table 8,192 strided elements and 2,048 at each end)."""
    h = hashlib.sha1()
    h.update(repr(ir.meta).encode())
    h.update(repr(cfg).encode())
    h.update(repr(cam).encode())
    h.update(f"{chunk_pixels}:{dtype}:{path_length}:torch1".encode())
    tables = ir.tables()
    # a copy of each non-empty table to the host, each a sync on a card
    with host_sync("bucket_cache_key",
                   sum(t.numel() > 0 for t in tables.values())):
        for name, t in tables.items():
            h.update(f"{name}{tuple(t.shape)}{t.dtype}".encode())
            flat = t.detach().reshape(-1)
            if flat.numel() * flat.element_size() > _HASH_WHOLE_BYTES:
                step = max(1, flat.numel() // 8192)
                flat = torch.cat([flat[::step][:8192], flat[:2048],
                                  flat[-2048:]])
            h.update(flat.cpu().numpy().tobytes())
    return h.hexdigest()


def _read_bucket_cache() -> dict:
    try:
        with open(_bucket_cache_path()) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return {}
    return entries if isinstance(entries, dict) else {}


def _bucket_cache_get(key: str):
    """The bucket tuple stored under `key`, or None."""
    v = _read_bucket_cache().get(key)
    return tuple(int(x) for x in v) if isinstance(v, list) else None


def _bucket_cache_put(key: str, buckets) -> None:
    """Store `buckets` under `key`: the file is written under a temporary
    name and renamed over the old one. A cache that cannot be written is
    skipped; it is never fatal."""
    path = _bucket_cache_path()
    with span("render.bucket_cache"):
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            entries = _read_bucket_cache()
            entries[key] = [int(b) for b in buckets]
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(entries, f)
            os.replace(tmp, path)
        except OSError:
            pass


def quantize_buckets(counts, margin):
    """Per-level spawn counts -> bucket sizes with `margin` headroom, in
    multiples of 4096 lanes (at least 256)."""
    return tuple(max(256, int(math.ceil(c * margin / 4096)) * 4096)
                 for c in counts)


def gi_gates(cfg):
    """(use_gi, shade_gi): photons are traced when any of the three GI
    flags is set (the generated main, yaml_parser.py:201), but the GI
    terms are applied at shading only under include_global or
    visualize_photon_map (setup_config, renderer.c:62) — a scene setting
    only visualize-soft-indirect traces photons and never reads them (a
    reference quirk, kept)."""
    use_gi = (cfg.include_global or cfg.visualize_photon_map
              or cfg.visualize_soft_indirect)
    return use_gi, cfg.include_global or cfg.visualize_photon_map


def needs_rng(ir: SceneIR, cam, cfg) -> bool:
    """Whether a frame draws random numbers (render.py:216-224 of the JAX
    package): camera jitter, a non-point aperture, a jittered light, or
    photon GI."""
    return bool(cam.aperture.jitter
                or cam.aperture.kind not in POINT_LIKE_APERTURES
                or any(info[3] for info in ir.meta.light_info)
                or (cfg.photon_count > 0 and gi_gates(cfg)[0]))


def primary_samples(cam, cam_rt, det_table, px, py, ck):
    """A chunk's per-sample pixel ids, subpixel offsets and aperture
    offsets (JAX render.py's chunk_rays): with camera jitter a fresh CMJ
    table per pixel from ck.split(2)[0] and the aperture's draws from the
    second child; else the deterministic table `det_table` and the
    aperture's draws from `ck` itself. `ck` is the chunk's RNG node (None:
    nothing drawn)."""
    n = px.shape[0]
    S = cam.usteps * cam.vsteps
    dtype = det_table.dtype
    ap_rng = ck
    if ck is None or not cam.aperture.jitter:
        uv = det_table[None].expand(n, S, 2).reshape(n * S, 2)
    else:
        kt, ap_rng = ck.split(2)
        uv = cmj_points_batched(*draw_cmj_batched(
            kt, n, cam.usteps, cam.vsteps, dtype), cam.usteps,
            cam.vsteps).reshape(n * S, 2)
    xs = None if ap_rng is None else draw_aperture(cam_rt, n * S, ap_rng,
                                                   dtype)
    ap = sample_aperture(cam_rt, n * S, dtype, det_table.device, xs)
    return px.repeat_interleave(S), py.repeat_interleave(S), uv, ap


def pixel_colors(ir: SceneIR, rt, cam_rt, px, py, uv, ap, n_samples: int,
                 path_length: int, remat=False, buckets=None, rng=None):
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
    checkpoints each wavefront level (integrator._make_level_fn). `rng`
    is the trace's RNG node (None for a scene that draws nothing).

    Gradients reach photon-mapped GI through a hook made with
    `make_gi_hook(..., live_power=True)`, whose live photon powers are
    computed here once per call, and clustered meshes through the mesh
    hit's t (integrator.mesh_hit_t). When a vertex table (tri_p1, tri_e1,
    tri_e2) requires grad, the mesh queries' triangle planes are packed
    from its current values once per call, so a trained mesh is traced
    where it now is; the cluster boxes stay those of `rt` (ROADMAP C14)."""
    bind = getattr(rt.gi_hook, "bind", None)
    if bind is not None:
        rt = rt._replace(gi_hook=bind(ir))
    if ir.meta.use_clusters and (ir.tri_p1.requires_grad
                                 or ir.tri_e1.requires_grad
                                 or ir.tri_e2.requires_grad):
        rt = rt._replace(mesh=rt.mesh._replace(tris=mesh.pack_tris(
            ir.tri_p1.detach(), ir.tri_e1.detach(), ir.tri_e2.detach())))
    orig, dirs = rays_for_pixels(cam_rt, px, py, uv, ap)
    if buckets is None:
        triple = trace(ir, rt, orig, dirs, path_length, remat=remat, rng=rng)
        overflow = torch.zeros((), dtype=torch.bool, device=orig.device)
    else:
        triple, overflow = trace_bucketed(
            ir, rt, orig, dirs, path_length, list(buckets), remat=remat,
            rng=rng)
    n = px.shape[0] // n_samples
    a = triple.a.reshape(n, n_samples, 3).mean(1)
    d = triple.d.reshape(n, n_samples, 3).mean(1)
    s = triple.s.reshape(n, n_samples, 3).mean(1)
    return (a + d + s) / 3.0, overflow


def render_scene(scene: SceneDesc, dtype=torch.float32,
                 chunk_pixels: int = 8192, device=None,
                 stats: Optional[dict] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 8,
                 seed: Optional[int] = None,
                 mesh: Optional[PixelMesh] = None,
                 timer: Optional[PhaseTimer] = None,
                 progress: bool = False) -> np.ndarray:
    """Render a scene to an (H, W, 3) float64 numpy canvas (linear,
    pre-encode), on `device` (default: the mesh's device, else the CUDA
    card; the CPU only when asked for).

    A scene that needs random numbers (`needs_rng`) draws them from the
    RNG tree of `seed` (0 when None): the same seed renders the same frame
    bit for bit. A deterministic scene draws nothing and ignores the
    seed. Photon GI traces its photon maps first, in the same call.
    Chunks are cut to SHADOW_RAYS_PER_CHUNK rays times the scene's most
    light samples plus its final-gather rays per lane. If `stats` is a
    dict, it receives the calibrated `buckets`, the counts of chunks that
    needed a bucket escalation (`escalations`) or the exact fallback
    (`exact_chunks`), and for GI the photon pass's `photon_seconds` and
    per-map statistics (`photons`, see photon.trace_photons).
    With `checkpoint_path`, the canvas and the count of finished chunks
    are written there every `checkpoint_every` chunks and after the last
    one; a render that finds a snapshot of the same chunking there
    resumes after its last finished chunk (with a mesh only rank 0
    writes it, and every rank reads it).

    With `mesh` (parallel/mesh.PixelMesh) every rank of the mesh calls
    this with the same arguments and receives the whole canvas; the
    chunk is rounded up to a multiple of the mesh's size, and the bucket
    calibration is not cached (see the module docstring). `timer` (a
    utils/profiling.PhaseTimer) is attached to the tracer for the call
    and records the phases compile_scene, trace_photons, probe_buckets
    and render_chunks; `progress` prints `chunk i/n` after each chunk.

    The call is the tracer's unit `render_scene`; its spans are
    `render.compile_scene`, `render.trace_photons`,
    `render.bucket_cache`, `render.probe_buckets` (each probe
    `render.probe`), `render.chunks` (each chunk's `render.enqueue`),
    and `sync.<site>` around each call that waits for the device."""
    remove = None if timer is None else add_sink(timer)
    try:
        with unit("render_scene"):
            return _render(scene, dtype, chunk_pixels, device, stats,
                           checkpoint_path, checkpoint_every, seed, mesh,
                           progress)
    finally:
        if remove is not None:
            remove()


def _render(scene, dtype, chunk_pixels, device, stats, checkpoint_path,
            checkpoint_every, seed, mesh, progress):
    cfg = scene.config
    cam = scene.camera
    if device is None and mesh is not None:
        device = mesh.device
    device = default_device(device)
    with span("render.compile_scene"):
        ir = compile_scene(scene, dtype=dtype, device=device)
        cam_rt = build_camera(cam, dtype=dtype, device=device)
        rt = build_statics(ir, cfg)
    if stats is None:
        stats = {}
    stats.update(buckets=None, escalations=0, exact_chunks=0)
    root = RNG(0 if seed is None else seed, device) \
        if needs_rng(ir, cam, cfg) else None

    use_gi, shade_gi = gi_gates(cfg)
    gather = 0
    if cfg.photon_count > 0 and use_gi:
        # maps populated as the generated main does (yaml_parser.py:201-216):
        # caustic iff include_caustics, global iff include_final_gather
        pstats = {}
        with timed_span("render.trace_photons",
                        count=cfg.photon_count) as pass_span:
            maps = photon.trace_photons(
                ir, rt, root.fold(PHOTON_FOLD), dtype,
                caustic=cfg.include_caustics,
                global_=cfg.include_final_gather, stats=pstats)
        stats.update(photon_seconds=pass_span.seconds, photons=pstats)
        if shade_gi:
            rt = rt._replace(gi_hook=photon.make_gi_hook(maps, cfg))
            if cfg.include_final_gather and maps.get(photon.GLOBAL):
                gather = cfg.gi_usteps * cfg.gi_vsteps

    W, H = cam.width, cam.height
    S = cam.usteps * cam.vsteps
    chunk_pixels = min(chunk_pixels, max(
        256, SHADOW_RAYS_PER_CHUNK
        // (S * (ir.meta.max_light_samples + gather))))
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    chunk_pixels = -(-chunk_pixels // size) * size
    shard = chunk_pixels // size
    path_length = cfg.di_path_length
    with host_sync("upload"):
        det_table = torch.as_tensor(cmj_points_static(
            cam.usteps, cam.vsteps)).to(device=device, dtype=dtype)
    use_bucketed = ir.meta.has_reflective or ir.meta.has_refractive

    def agreed(t):
        # with a mesh, the largest value over its ranks, so that every rank
        # takes the same branch
        if mesh is None:
            return t
        return all_reduce_(mesh, t.to(torch.int64).reshape(-1),
                           torch.distributed.ReduceOp.MAX)

    def probe_counts(px, py, ck):
        with span("render.probe"):
            counts = spawn_counts(ir, rt, *rays_for_pixels(
                cam_rt, *primary_samples(cam, cam_rt, det_table, px, py,
                                         ck)), path_length)
            if not counts:
                return []
            with host_sync("probe_counts"):
                return agreed(torch.stack(counts)).tolist()

    def render_chunk(px, py, ck, buckets):
        with span("render.enqueue"):
            res, ovf = pixel_colors(
                ir, rt, cam_rt,
                *primary_samples(cam, cam_rt, det_table, px, py, ck), S,
                path_length, buckets=buckets,
                rng=None if ck is None else ck.fold(1))
        with host_sync("overflow"):
            return res, bool(agreed(ovf))

    total = W * H
    n_chunks = math.ceil(total / chunk_pixels)

    def chunk_arrays(c):
        # this rank's shard of chunk c, its pixel ids made on the device;
        # the tail chunk is padded to the fixed chunk size with pixel
        # (0, 0), cut off afterwards
        lo = c * chunk_pixels + rank * shard
        idx = torch.arange(lo, lo + shard, device=device)
        idx = torch.where(idx < total, idx, 0)
        ck = None if root is None else root.fold(c)
        if ck is not None and mesh is not None:
            ck = ck.fold(rank)
        return idx % W, idx // W, ck

    buckets = cache_key = None
    if use_bucketed:
        if mesh is None:
            with span("render.bucket_cache"):
                cache_key = _bucket_cache_key(ir, cfg, cam, chunk_pixels,
                                              dtype, path_length)
                buckets = _bucket_cache_get(cache_key)
        if buckets is None:
            # ONE calibration for the whole render: max per-level spawn
            # counts over five sampled chunks (the top of the image is
            # often background and alone would under-size every bucket),
            # 1.5x margin
            with span("render.probe_buckets"):
                samples = sorted({0, n_chunks // 4, n_chunks // 2,
                                  (3 * n_chunks) // 4, n_chunks - 1})
                counts = [probe_counts(*chunk_arrays(c)) for c in samples]
                buckets = quantize_buckets([max(v) for v in zip(*counts)],
                                           1.5)
            if cache_key is not None:
                _bucket_cache_put(cache_key, buckets)
        stats["buckets"] = buckets

    out = np.zeros((total, 3), dtype=np.float64)
    start_chunk = 0
    if checkpoint_path is not None:
        snap = load_render_progress(checkpoint_path)
        if snap is not None and snap["total_chunks"] == n_chunks \
                and snap["canvas"].shape == (total, 3):
            out = snap["canvas"]
            start_chunk = snap["chunks_done"]
    with span("render.chunks", n=n_chunks - start_chunk):
        for c in range(start_chunk, n_chunks):
            lo = c * chunk_pixels
            hi = min(lo + chunk_pixels, total)
            px, py, ck = chunk_arrays(c)
            res, ovf = render_chunk(px, py, ck, buckets)
            if ovf:
                # exact per-level counts for THIS chunk; the escalated
                # buckets serve the rest of the render
                esc = quantize_buckets(probe_counts(px, py, ck), 1.2)
                buckets = tuple(max(a, b) for a, b in zip(buckets, esc))
                stats["buckets"] = buckets
                stats["escalations"] += 1
                if cache_key is not None:
                    _bucket_cache_put(cache_key, buckets)
                print(f"bucket overflow: recalibrated to {buckets}",
                      flush=True)
                res, ovf = render_chunk(px, py, ck, buckets)
            if ovf:
                # probe ceiling exceeded (spawns > 3x primary): never
                # silent — the unrolled exact path re-renders the chunk
                stats["exact_chunks"] += 1
                print(f"bucket overflow persists (buckets={buckets}): "
                      "chunk re-rendered on the exact unrolled path",
                      flush=True)
                res, _ = render_chunk(px, py, ck, None)
            with host_sync("canvas"):
                if mesh is not None:
                    res = gather_rows(mesh, res)
                out[lo:hi] = res[: hi - lo].cpu().double().numpy()
            if checkpoint_path is not None and rank == 0 and (
                    (c + 1) % checkpoint_every == 0 or c + 1 == n_chunks):
                save_render_progress(checkpoint_path, out, c + 1, n_chunks)
            if progress:
                print(f"chunk {c + 1}/{n_chunks}", flush=True)
    return out.reshape(H, W, 3)
