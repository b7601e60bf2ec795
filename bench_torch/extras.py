"""The bench's other cells: bench_extras.py's counterparts on the port, and
one cell for each further frame that chip_smoke.py times.

Each cell is `cell(device=None, reps=3, seed=None, **sizes)`; its defaults
are the sizes it measures, and it returns {"metrics", "info"}. A cell
that draws random numbers takes `seed` (None: the JAX cell's own seed);
a failed gate raises GateFailed. The JAX package's scenes that are not in
the repo are replaced by the in-repo scenes PERF.md section 4 names:
`cornell_box` for cornell_small.yml, `mesh_torus` for bbox_tiny.yml.

- fwd_bwd: one Adam step of `make_train_step` over every float table of
  the 800x400 flagship against a zero target, each timed step taken from
  the same starting state, as the JAX cell times one jitted step; remat
  "level" and "none", buckets from one probe at 1.2x;
- cornell_gi: render_scene(cornell_box(800, 800)) at seed 7, photon pass
  included, cold and warm;
- fwd_bwd_cornell: the forward+backward of the whole 800x800 Cornell
  frame, sum((img - 0.5)^2) a chunk with live photon powers and remat
  "level", all 640,000 pixels in chunks of FB_CHUNK, buckets from every
  chunk's probe at FB_MARGIN, overflow gated (the JAX cell drops the
  frame's last 1,024 pixels and the flag); photons at seed 7, the chunks'
  draws at seed 11, as the JAX cell keys them;
- mesh: render_scene(mesh_torus(600, 240)), 141,312 triangles, one light;
- mesh_stream: mesh closest on a 512k-triangle soup, the kernel against
  the plain version, parity bitwise;
- scaling: glass_spheres(1024, 1024) through render_scene(mesh=) on a
  world of one rank and of two (bench_torch/ranks.py's placement: NCCL
  with a card a rank, else gloo ranks sharing the card, which then
  time-slice it and give no scaling figure);
- showcase, soft (through the command line), dof: the frames of
  chip_smoke.py phases 11, 15 and 22.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.__main__ import main as cli_main
from fast_ray_tracer_tpu_torch.io.ppm import read_ppm
from fast_ray_tracer_tpu_torch.ops import mesh as mesh_ops
from fast_ray_tracer_tpu_torch.parallel.train import (
    make_train_step, merge_params, split_params,
)
from fast_ray_tracer_tpu_torch.render import photon
from fast_ray_tracer_tpu_torch.render.camera import (
    build_camera, rays_for_pixels,
)
from fast_ray_tracer_tpu_torch.render.integrator import (
    build_statics, spawn_counts,
)
from fast_ray_tracer_tpu_torch.render.render import (
    PHOTON_FOLD, pixel_colors, primary_samples, quantize_buckets,
    render_scene,
)
from fast_ray_tracer_tpu_torch.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu_torch.sampling.rng import RNG
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.demo import (
    SOFT_DIR, SOFT_SEGMENTS, cornell_box, glass_spheres, mesh_torus, primitives_showcase,
    soft_textured,
)
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR, SceneMeta
from fast_ray_tracer_tpu_torch.scene.model import ApertureDesc, replace

from bench_torch import ranks
from bench_torch.common import (
    ALL_KERNELS, COMPACTION, GateFailed, call_ms, fresh_memory, launches,
    metric, peak_gib, rates, require_finite, require_launched,
    require_no_overflow, reset_launches, resolve, timed,
)

F32 = torch.float32
GI_SEED = 7               # bench_extras.cornell_gi's and the photons' key
FB_DRAW_SEED = 11         # bench_extras.fwd_bwd_cornell's chunk key
# the Cornell forward+backward's chunk: 5 chunks cover the frame, and a
# chunk of 2^17 pixels peaked at 33.188 GiB on an NVIDIA H100 80GB HBM3,
# 700.00 W (tools/cornell_fwd_bwd_chunks.py; PERF.md section 6)
FB_CHUNK = 1 << 17
FB_PEAK_BUDGET = 40 << 30
FB_MARGIN = 1.35          # bench_extras.fwd_bwd_cornell's bucket margin
CORNELL_RAYS_PER_PX = 110  # 1 primary, 100 area-light shadow, 9 gather


def _frames(device, reps, scene, kernels, what, seed=None):
    """render_scene of `scene` in float32, the whole frame one chunk: a
    counted cold call (compile, probe, photon pass) and `reps` warm calls,
    each bitwise the cold one; gates on overflow, shape, finiteness and
    the launches of `kernels`. Returns (cold s, warm walls, stats of the
    cold call, launches of the cold call)."""
    cam = scene.camera
    kw = dict(dtype=F32, device=device, chunk_pixels=cam.width * cam.height,
              seed=seed)
    reset_launches()
    stats = {}
    first, cold = timed(device, lambda: render_scene(scene, stats=stats,
                                                     **kw))
    counted = launches()
    require_no_overflow(stats, what)
    if first.shape != (cam.height, cam.width, 3):
        raise GateFailed(f"{what}: canvas of shape {first.shape}")
    require_finite(first, f"the {what} canvas")
    require_launched(device, counted, kernels, what)
    warm, warm_stats = [], []
    for _ in range(max(reps, 1)):
        st = {}
        again, wall = timed(device, lambda: render_scene(scene, stats=st,
                                                         **kw))
        require_no_overflow(st, what)
        if not np.array_equal(again, first):
            raise GateFailed(f"a warm {what} frame differs from the first")
        warm.append(wall)
        warm_stats.append(st)
    return cold, warm, [stats] + warm_stats, counted


def _frame_metrics(prefix, pixels, cold, warm, device):
    return {f"{prefix}_cold_s": metric(cold, "s"),
            f"{prefix}_warm_s": metric(warm, "s"),
            f"{prefix}_warm_px_per_s": metric(rates(pixels, warm), "px/s"),
            f"{prefix}_peak_gib": metric(peak_gib(device), "GiB")}


# ---------------------------------------------------------------------------
# forward+backward
# ---------------------------------------------------------------------------

def fwd_bwd(device=None, reps=3, seed=None, width=800, height=400):
    """bench_extras.fwd_bwd_ms on the port: step ms and peak memory in remat
    "level" and "none"; gates: no overflow, finite losses, a finite and
    non-zero gradient L1, both compaction kernels in the forward and the
    backward."""
    device = resolve(device)
    fresh_memory(device)
    scene = glass_spheres(width, height)
    depth = scene.config.di_path_length
    ir = compile_scene(scene, dtype=F32, device=device)
    cam_rt = build_camera(scene.camera, dtype=F32, device=device)
    rt = build_statics(ir, scene.config)
    n = width * height
    px = torch.arange(width, device=device).repeat(height)
    py = torch.arange(height, device=device).repeat_interleave(width)
    uv = torch.as_tensor(cmj_points_static(1, 1), dtype=F32).to(device) \
        .expand(n, 2)
    ap = torch.zeros((n, 2), dtype=F32, device=device)
    target = torch.zeros((n, 3), dtype=F32, device=device)
    counts = torch.stack(spawn_counts(
        ir, rt, *rays_for_pixels(cam_rt, px, py, uv, ap), depth)).tolist()
    buckets = quantize_buckets(counts, 1.2)
    params, static = split_params(ir)
    start = {k: v.detach().clone() for k, v in params.items()}
    metrics, info = {}, {"size": [width, height], "buckets": list(buckets)}
    for remat in ("level", "none"):
        init, step = make_train_step(rt, cam_rt, static, 1, depth,
                                     remat=remat, buckets=buckets)
        fresh_memory(device)
        walls, losses, flags, l1 = [], [], [], []
        for i in range(1 + max(reps, 1)):
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(start[k])
            state = init(params)
            fwd = {}
            reset_launches()
            (state, loss, ovf), wall = timed(device, lambda: step(
                state, px, py, uv, ap, target,
                between=lambda: fwd.update(launches())))
            if i == 0:
                bwd = {k: v - fwd[k] for k, v in launches().items()}
                require_launched(device, fwd, COMPACTION,
                                 f"the {remat} step's forward")
                require_launched(device, bwd, COMPACTION,
                                 f"the {remat} step's backward")
            else:
                walls.append(wall)
            losses.append(loss)
            flags.append(ovf)
            l1.append(sum(p.grad.abs().sum() for p in params.values()
                          if p.grad is not None))
        if bool(torch.stack(flags).any()):
            raise GateFailed(f"a {remat} step overflowed its buckets")
        losses = torch.stack(losses).tolist()
        l1 = torch.stack(l1).tolist()
        if not np.isfinite(losses).all():
            raise GateFailed(f"non-finite {remat} loss {losses}")
        if not (np.isfinite(l1).all() and min(l1) > 0.0):
            raise GateFailed(f"{remat} gradient L1 not finite and positive: "
                             f"{l1}")
        metrics[f"fwd_bwd_ms_800x400_d5_{remat}"] = metric(
            [w * 1e3 for w in walls], "ms")
        metrics[f"fwd_bwd_peak_gib_{remat}"] = metric(peak_gib(device),
                                                      "GiB")
        info[f"loss_{remat}"] = losses[0]
        info[f"grad_l1_{remat}"] = l1[0]
    return {"metrics": metrics, "info": info}


def fwd_bwd_cornell(device=None, reps=3, seed=None, width=800, height=800,
                    photons=None, chunk=FB_CHUNK, block=True):
    """bench_extras.fwd_bwd_cornell on the port, as chip_smoke.py phases
    28-29 run it: a cold frame (the probe of every chunk, then the frame)
    and `reps` warm frames, each the chunks' losses and gradients
    accumulated, one sync at its end; gates: no chunk overflowed, a finite
    loss and gradient, a positive L1 of the mat_Kd and light_intensity
    gradients, a non-zero tri_p1 gradient, the peak within FB_PEAK_BUDGET,
    every kernel in the forwards and both compaction kernels in the
    backwards. `block=False` leaves the clustered block out (small CPU
    runs)."""
    device = resolve(device)
    fresh_memory(device)
    photon_seed, draw_seed = (GI_SEED, FB_DRAW_SEED) if seed is None \
        else (seed, seed)
    scene = cornell_box(width, height, mesh=block)
    if photons is not None:
        scene.config = replace(scene.config, photon_count=photons)
    cfg, cam = scene.config, scene.camera
    depth = cfg.di_path_length
    ir = compile_scene(scene, dtype=F32, device=device)
    rt = build_statics(ir, cfg)
    maps, photon_s = timed(device, lambda: photon.trace_photons(
        ir, rt, RNG(photon_seed, device).fold(PHOTON_FOLD), F32,
        caustic=cfg.include_caustics, global_=cfg.include_final_gather))
    rt = rt._replace(gi_hook=photon.make_gi_hook(maps, cfg, live_power=True))
    cam_rt = build_camera(cam, dtype=F32, device=device)
    det = torch.as_tensor(cmj_points_static(1, 1)).to(device=device,
                                                      dtype=F32)
    params, static = split_params(ir)
    root = RNG(draw_seed, device)
    total = width * height
    n_chunks = -(-total // chunk)

    def chunk_args(c):
        idx = torch.arange(c * chunk, min((c + 1) * chunk, total),
                           device=device)
        ck = root.fold(c)
        return primary_samples(cam, cam_rt, det, idx % width, idx // width,
                               ck), ck.fold(1)

    def probe():
        """The buckets: every chunk's spawn counts, the most of each level
        at FB_MARGIN, in multiples of 256 lanes."""
        counts = [torch.stack(spawn_counts(ir, rt, *rays_for_pixels(
            cam_rt, *chunk_args(c)[0]), depth)).tolist()
            for c in range(n_chunks)]
        return [max(256, int(np.ceil(max(v) * FB_MARGIN / 256.0)) * 256)
                for v in zip(*counts)]

    def frame(buckets):
        for p in params.values():
            p.grad = None
        fwd = dict.fromkeys(ALL_KERNELS, 0)
        bwd = dict(fwd)
        losses, flags = [], []
        for c in range(n_chunks):
            samples, rng = chunk_args(c)
            reset_launches()
            img, ovf = pixel_colors(merge_params(params, static), rt, cam_rt,
                                    *samples, 1, depth, remat="level",
                                    buckets=buckets, rng=rng)
            loss = ((img - 0.5) ** 2).sum()
            f = launches()
            loss.backward()
            b = launches()
            for k in fwd:
                fwd[k] += f[k]
                bwd[k] += b[k] - f[k]
            losses.append(loss.detach())
            flags.append(ovf)
        return torch.stack(losses).sum(), torch.stack(flags).any(), fwd, bwd

    def checked(out):
        loss, ovf, fwd, bwd = out
        if bool(ovf):
            raise GateFailed("a Cornell forward+backward chunk overflowed "
                             "its buckets")
        g = {k: p.grad for k, p in params.items() if p.grad is not None}
        if not (np.isfinite(float(loss)) and all(
                bool(torch.isfinite(x).all()) for x in g.values())):
            raise GateFailed("non-finite Cornell loss or gradient")
        l1 = float(g["mat_Kd"].abs().sum() + g["light_intensity"].abs().sum())
        if not l1 > 0.0:
            raise GateFailed("zero Kd/intensity gradient")
        if block and not float(g["tri_p1"].abs().max()) > 0.0:
            raise GateFailed("zero vertex gradient")
        require_launched(device, fwd, ALL_KERNELS if block else COMPACTION,
                         "the Cornell forwards")
        require_launched(device, bwd, COMPACTION, "the Cornell backwards")
        return l1

    buckets, probe_s = timed(device, probe)
    out, cold = timed(device, lambda: frame(buckets))
    cold += probe_s
    l1 = [checked(out)]
    walls = []
    for _ in range(max(reps, 1)):
        out, wall = timed(device, lambda: frame(buckets))
        l1.append(checked(out))
        walls.append(wall)
    peak = peak_gib(device)
    if peak is not None and peak > FB_PEAK_BUDGET / 2**30:
        raise GateFailed(f"the Cornell forward+backward peaked at {peak:.3f} "
                         "GiB, past its budget")
    return {"metrics": {
        "fwd_bwd_ms_cornell_800x800": metric([w * 1e3 for w in walls], "ms"),
        "cornell_fwd_bwd_chunk_ms": metric(
            [w * 1e3 / n_chunks for w in walls], "ms"),
        "cornell_fwd_bwd_cold_ms": metric(cold * 1e3, "ms"),
        "cornell_fwd_bwd_photon_pass_s": metric(photon_s, "s"),
        "cornell_fwd_bwd_grad_l1_mat_kd_light": metric(l1, "1"),
        "cornell_fwd_bwd_peak_gib": metric(peak, "GiB")},
        "info": {"size": [width, height], "chunk": chunk,
                 "chunks": n_chunks, "buckets": buckets,
                 "photon_count": cfg.photon_count,
                 "seeds": {"photons": photon_seed, "draws": draw_seed}}}


# ---------------------------------------------------------------------------
# GI and mesh frames
# ---------------------------------------------------------------------------

def cornell_gi(device=None, reps=3, seed=None, width=800, height=800,
               photons=None, block=True):
    """bench_extras.cornell_gi on the port (cornell_box for the absent
    cornell_small.yml): cold and warm walls, the photon pass, px/s and the
    lower-bound rays/s at CORNELL_RAYS_PER_PX rays a pixel, peak memory;
    the photon pass of the warm calls (the cold one's apart: its first
    calls of each operation).
    The JAX cell's vs_ref keys are left out: their reference timing
    (timings.txt) is not in the repo. `block=False` leaves the clustered
    block out (small CPU runs)."""
    device = resolve(device)
    fresh_memory(device)
    seed = GI_SEED if seed is None else seed
    scene = cornell_box(width, height, mesh=block)
    if photons is not None:
        scene.config = replace(scene.config, photon_count=photons)
    cold, warm, stats, counted = _frames(
        device, reps, scene, ALL_KERNELS if block else COMPACTION,
        "Cornell GI", seed)
    px = width * height
    return {"metrics": {
        "cornell_gi_800x800_wall_s": metric(cold, "s"),
        "cornell_gi_800x800_warm_wall_s": metric(warm, "s"),
        "cornell_gi_photon_pass_s": metric(
            [st["photon_seconds"] for st in stats[1:]], "s"),
        "cornell_gi_photon_pass_cold_s": metric(stats[0]["photon_seconds"],
                                                "s"),
        "cornell_gi_px_per_s": metric(px / cold, "px/s"),
        "cornell_gi_warm_px_per_s": metric(rates(px, warm), "px/s"),
        "cornell_gi_rays_per_s_lb": metric(px * CORNELL_RAYS_PER_PX / cold,
                                           "rays/s"),
        "cornell_gi_warm_rays_per_s_lb": metric(
            rates(px * CORNELL_RAYS_PER_PX, warm), "rays/s"),
        "cornell_gi_peak_gib": metric(peak_gib(device), "GiB")},
        "info": {"size": [width, height], "seed": seed,
                 "photon_count": scene.config.photon_count,
                 "buckets": stats[0]["buckets"], "launches": counted}}


def mesh(device=None, reps=3, seed=None, width=600, height=240,
         segments=(384, 184)):
    """bench_extras.mesh_bbox on the port (mesh_torus for the absent
    bbox_tiny.yml, 2 x 384 x 184 = 141,312 triangles, one light): cold and
    warm walls, px/s, and the traced rays/s of chip_smoke.py phase 8: the
    primary rays and every child the probe counts, each with one shadow
    ray per light (not the JAX cell's 5 rays a pixel, which assumes four
    lights)."""
    device = resolve(device)
    fresh_memory(device)
    scene = mesh_torus(width, height, segments=tuple(segments))
    cold, warm, stats, counted = _frames(device, reps, scene, ALL_KERNELS,
                                         "mesh")
    ir = compile_scene(scene, dtype=F32, device=device)
    rt = build_statics(ir, scene.config)
    n = width * height
    cam_rt = build_camera(scene.camera, dtype=F32, device=device)
    uv = torch.full((n, 2), 0.5, dtype=F32, device=device)
    spawned = torch.stack(spawn_counts(ir, rt, *rays_for_pixels(
        cam_rt, torch.arange(width, device=device).repeat(height),
        torch.arange(height, device=device).repeat_interleave(width), uv,
        torch.zeros_like(uv)), scene.config.di_path_length)).tolist()
    traced = (n + sum(spawned)) * (1 + ir.meta.n_lights)
    return {"metrics": {
        "mesh_141k_tri_600x240_wall_s": metric(cold, "s"),
        "mesh_141k_tri_600x240_warm_wall_s": metric(warm, "s"),
        "mesh_141k_tri_px_per_s": metric(n / cold, "px/s"),
        "mesh_141k_tri_warm_px_per_s": metric(rates(n, warm), "px/s"),
        "mesh_141k_tri_warm_traced_rays_per_s": metric(rates(traced, warm),
                                                       "rays/s"),
        "mesh_141k_tri_peak_gib": metric(peak_gib(device), "GiB")},
        "info": {"size": [width, height],
                 "triangles": ir.meta.n_triangles, "traced_rays": traced,
                 "spawn_counts": spawned, "buckets": stats[0]["buckets"],
                 "launches": counted}}


def build_soup(device, n_tri=512 * 1024, n_rays=16384, seed=0):
    """tools/bench_mesh_stream.py's soup: 64-triangle clusters along a
    coarse grid walk (numpy seed `seed`) and rays between random points of
    the grid (seed + 1). Returns (SceneIR, origins, directions)."""
    c = 64
    nc = n_tri // c
    rng = np.random.default_rng(seed)
    g = max(2, int(round(nc ** (1 / 3))))
    idx = np.arange(nc)
    centers = np.stack([idx % g, (idx // g) % g, idx // (g * g)],
                       -1).astype(np.float32)
    centers += rng.normal(0, 0.1, centers.shape)
    base = centers[:, None, :] + rng.normal(0, 0.25, (nc, c, 3))
    p1 = base.reshape(-1, 3).astype(np.float32)
    e1 = rng.normal(0, 0.2, (nc * c, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.2, (nc * c, 3)).astype(np.float32)
    v = np.stack([p1, p1 + e1, p1 + e2], 1)
    meta = SceneMeta(n_triangles=nc * c, use_clusters=True, n_clusters=nc,
                     cluster_size=c)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ir = SceneIR(meta=meta, tri_p1=t(p1), tri_e1=t(e1), tri_e2=t(e2),
                 cluster_min=t(v.reshape(nc, c * 3, 3).min(1)),
                 cluster_max=t(v.reshape(nc, c * 3, 3).max(1)))
    extent = float(centers.max())
    rng = np.random.default_rng(seed + 1)
    o = rng.uniform(-2, extent + 2, (n_rays, 3)).astype(np.float32)
    tgt = rng.uniform(0, extent, (n_rays, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ir, t(o), t(d)


def mesh_stream(device=None, reps=3, seed=None, n_tri=512 * 1024,
                n_rays=16384):
    """bench_extras.mesh_stream on the port: `mesh.closest` on the
    512k-triangle soup (the kernel on the card, its plain version on the
    CPU) against `closest_plain`, timed call by call (CUDA events on the
    card); gate: the two outputs bitwise equal, the kernel launched."""
    device = resolve(device)
    fresh_memory(device)
    ir, orig, dirs = build_soup(device, n_tri, n_rays,
                                0 if seed is None else seed)
    nt = ir.tri_p1.shape[0]
    tables = mesh_ops.pack(
        ir, torch.arange(nt, dtype=torch.int32, device=device),
        torch.ones(nt, dtype=torch.bool, device=device))
    reset_launches()
    got = mesh_ops.closest(tables, orig, dirs)
    require_launched(device, launches(), ("mesh_closest",), "mesh stream")
    want = mesh_ops.closest_plain(tables, orig, dirs)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    if not same:
        raise GateFailed("mesh closest differs from its plain version on the "
                         "soup")
    kernel = call_ms(device, lambda: mesh_ops.closest(tables, orig, dirs),
                     max(reps, 20))
    plain = call_ms(device, lambda: mesh_ops.closest_plain(tables, orig,
                                                           dirs), reps)
    return {"metrics": {
        "mesh_stream_512k_ms": metric(kernel, "ms"),
        "mesh_stream_512k_plain_ms": metric(plain, "ms"),
        "mesh_stream_parity": metric(same, "bool")},
        "info": {"triangles": nt, "rays": n_rays,
                 "hits": int(torch.isfinite(want[0]).sum())}}


# ---------------------------------------------------------------------------
# scaling over ranks
# ---------------------------------------------------------------------------

def _scaling_rank(pmesh, out, width, height, chunk, reps):
    """One rank of the scaling cell: a cold and `reps` warm sharded
    renders, each after a barrier; rank 0 leaves the canvas in `out`."""
    scene = glass_spheres(width, height)
    device = pmesh.device
    walls = []
    for i in range(1 + reps):
        torch.distributed.barrier(group=pmesh.group)
        reset_launches()
        stats = {}
        canvas, wall = timed(device, lambda: render_scene(
            scene, dtype=F32, chunk_pixels=chunk, mesh=pmesh, stats=stats))
        require_no_overflow(stats, "the sharded render")
        require_finite(canvas, "the sharded canvas")
        if i == 0:
            counted = launches()
            require_launched(device, counted, COMPACTION,
                             f"rank {pmesh.rank}'s render")
        walls.append(wall)
    if pmesh.rank == 0:
        np.save(os.path.join(out, "canvas.npy"), canvas)
    return {"walls": walls, "launches": counted}


def scaling(device=None, reps=3, seed=None, width=1024, height=1024,
            chunk=131072):
    """bench_extras.scaling_cpu_mesh on the port: the sharded render of
    glass_spheres at 1024x1024 in chunks of 131,072 pixels on a world of
    one rank and of two, both through render_scene(mesh=) (both probe
    every call: a mesh render keeps no bucket cache), both worlds on the
    two-rank world's backend; gates: the two canvases bitwise equal,
    finite, no overflow, both compaction kernels on every rank. The walls
    are rank 0's; shard overhead = wall(2) / wall(1) of the medians."""
    device = resolve(device)
    fresh_memory(device)
    backend = ranks.placement(2, device)["backend"]
    walls, canvases, where = {}, {}, {}
    for n in (1, 2):
        where[n], res, out = ranks.spawn(
            "bench_torch.extras:_scaling_rank", n, device,
            {"width": width, "height": height, "chunk": chunk,
             "reps": max(reps, 1)}, backend=backend)
        try:
            canvases[n] = np.load(os.path.join(out, "canvas.npy"))
        finally:
            shutil.rmtree(out, ignore_errors=True)
        walls[n] = res[0]["walls"]
    if not np.array_equal(canvases[1], canvases[2]):
        raise GateFailed("the two-rank canvas differs from the one-rank one")
    shared = where[2]["shared"]
    w1, w2 = (metric(walls[n][1:], "s") for n in (1, 2))
    return {"metrics": {
        "scaling_1Mpx_wall_s_1": w1,
        "scaling_1Mpx_wall_s_2": w2,
        "scaling_1Mpx_cold_s_1": metric(walls[1][0], "s"),
        "scaling_1Mpx_cold_s_2": metric(walls[2][0], "s"),
        "scaling_1Mpx_shard_overhead": metric(w2["value"] / w1["value"],
                                              "ratio")},
        "info": {"size": [width, height], "chunk": chunk, "backend": backend,
                 "ranks_share_card": shared,
                 "note": ("two ranks share one card and time-slice it: not a "
                          "scaling figure" if shared else
                          "one rank per card")}}


# ---------------------------------------------------------------------------
# the frames chip_smoke.py times (ROADMAP A7)
# ---------------------------------------------------------------------------

def showcase(device=None, reps=3, seed=None, width=800, height=400):
    """primitives_showcase (chip_smoke.py phase 11): every analytic shape,
    pattern and uv map, Perlin bump, CSG; both compaction kernels."""
    device = resolve(device)
    fresh_memory(device)
    cold, warm, stats, counted = _frames(
        device, reps, primitives_showcase(width, height), COMPACTION,
        "showcase")
    return {"metrics": _frame_metrics("showcase_800x400", width * height,
                                      cold, warm, device),
            "info": {"size": [width, height], "buckets": stats[0]["buckets"],
                     "launches": counted}}


def dof_scene(width=800, height=400):
    """glass_spheres through a circular aperture with 2x2 camera jitter
    (chip_smoke.py phase 22)."""
    sc = glass_spheres(width, height)
    sc.camera = replace(sc.camera, usteps=2, vsteps=2, aperture=ApertureDesc(
        kind="CIRCULAR_APERTURE", size=0.05, params=(1.0,), jitter=True))
    return sc


def dof(device=None, reps=3, seed=None, width=800, height=400):
    """The depth-of-field frame at seed 7 (chip_smoke.py phase 22): every
    warm frame bitwise the first; both compaction kernels."""
    device = resolve(device)
    fresh_memory(device)
    seed = GI_SEED if seed is None else seed
    cold, warm, stats, counted = _frames(device, reps,
                                         dof_scene(width, height),
                                         COMPACTION, "DoF", seed)
    return {"metrics": _frame_metrics("dof_800x400", width * height, cold,
                                      warm, device),
            "info": {"size": [width, height], "seed": seed,
                     "buckets": stats[0]["buckets"], "launches": counted}}


def soft(device=None, reps=3, seed=None, width=800, height=400,
         segments=SOFT_SEGMENTS):
    """soft_textured through the command line (chip_smoke.py phase 15):
    load, compile, render and both files written, into a temporary
    directory; gates: no overflow, every kernel launched, the PPM of the
    frame's size and finite. Another torus than the 2 x 384 x 184
    triangles of soft_textured.yml (`segments`) is named in a YAML of its
    own beside it."""
    device = resolve(device)
    fresh_memory(device)
    soft_textured(segments=tuple(segments))   # writes the YAML and files
    yml = SOFT_DIR / "soft_textured.yml"
    if tuple(segments) != SOFT_SEGMENTS:
        text = yml.read_text().replace("torus_uv_%dx%d.obj" % SOFT_SEGMENTS,
                                       "torus_uv_%dx%d.obj" % segments)
        yml = SOFT_DIR / ("soft_textured_%dx%d.yml" % segments)
        tmp = yml.with_name(f"{yml.name}.{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, yml)              # no reader sees a partial file
    out = tempfile.mkdtemp(prefix="frt_bench_soft_")
    argv = [str(yml), "-o",
            os.path.join(out, "soft"), "--chunk", str(width * height),
            "--quiet", "--dtype", "f32", "--width", str(width), "--height",
            str(height), "--device", device.type]
    try:
        reset_launches()
        stats = {}
        _, cold = timed(device, lambda: cli_main(argv, stats=stats))
        counted = launches()
        require_no_overflow(stats, "soft")
        require_launched(device, counted, ALL_KERNELS, "soft")
        canvas = read_ppm(os.path.join(out, "soft.ppm"))
        if canvas.shape != (height, width, 3):
            raise GateFailed(f"soft PPM of shape {canvas.shape}")
        require_finite(canvas, "the soft PPM")
        warm = []
        for _ in range(max(reps, 1)):
            st = {}
            _, wall = timed(device, lambda: cli_main(argv, stats=st))
            require_no_overflow(st, "soft")
            warm.append(wall)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return {"metrics": _frame_metrics("soft_800x400", width * height, cold,
                                      warm, device),
            "info": {"size": [width, height], "buckets": stats["buckets"],
                     "launches": counted}}


CELLS = {"fwd_bwd": fwd_bwd, "cornell_gi": cornell_gi,
         "fwd_bwd_cornell": fwd_bwd_cornell, "mesh": mesh,
         "mesh_stream": mesh_stream, "scaling": scaling,
         "showcase": showcase, "soft": soft, "dof": dof}
