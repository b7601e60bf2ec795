"""`train`: an inverse-rendering job, one client.

Traffic parameters (benchmark/traffic/<mix>.json): `first_steps`.

Set-up builds the job and its train step (the port's make_train_step,
Adam) and takes its first `first_steps` steps, the same object the
window then drives: whole steps (forward, backward, Adam, the loss read
back) on the following batches, from the evolving state, until the clock
passes `--seconds`. `step_s` is the window's wall over its steps; the
run's `info` keeps each step's wall and what the host did in the window
(benchmark/host.py: collections, context switches, threads). A step
that overflows its buckets or whose loss is not finite has failed. After
the window the reference follows the first `reference_steps` steps (the
configuration's `train`, else all of them) on its own job
(compare.train_numbers). With `--trace 1` the configuration's
`trace_units` steps spread over the window run under the profiler, each
marked by make_train_step's `between` callback, after its forward.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import generator as g
from benchmark import host
from benchmark import trace as tr
from benchmark.reference import compare
from benchmark.trace import sync


class Job:
    """An inverse-rendering job on one side, the program's or the
    reference's (`mods`, the modules of either, by the same names). The
    scene's float tables are the parameters. Step i's batch (`batch`) is
    the whole frame, or the configuration's `batch_pixels` pixels drawn
    uniformly from it by a generator seeded from the run's seed and i.
    Photon GI traces its maps once, from the fixed seed `photon_seed`,
    with live photon powers; step i's final gather draws from the RNG
    tree of the i-th seed drawn from the run's. The buckets come from the
    spawn counts of the first `first` batches at the configuration's
    margin. The target (`set_target`) is the frame rendered with mat_Kd
    scaled by per-material factors, in batches of the same size over a
    fixed permutation of the pixels. The benchmark hands both sides the
    same scene file, seed and factors; each side works out the rest."""

    def __init__(self, mods, scene_file, dtype, dev, tc, seed, first,
                 photon_dtype=None):
        scene = mods.load_scene(scene_file)
        cfg, cam = scene.config, scene.camera
        self.mods, self.cam_desc, self.dev, self.seed = mods, cam, dev, seed
        self.depth = cfg.di_path_length
        self.ir = mods.compile_scene(scene, dtype=dtype, device=dev)
        self.rt = mods.build_statics(self.ir, cfg)
        self.cam = mods.build_camera(cam, dtype=dtype, device=dev)
        self.det = torch.as_tensor(mods.cmj_points_static(1, 1)).to(
            device=dev, dtype=dtype)
        self.n = cam.width * cam.height
        self.size = int(tc.get("batch_pixels") or self.n)
        self.gi = cfg.photon_count > 0
        if self.gi:
            # `photon_dtype` (the control's): the photons traced in another
            # precision, on tables compiled in it, the maps then cast
            pdt = photon_dtype or dtype
            pir = self.ir if pdt == dtype else mods.compile_scene(
                scene, dtype=pdt, device=dev)
            maps = mods.trace_photons(
                pir, mods.build_statics(pir, cfg) if pdt != dtype
                else self.rt, mods.RNG(tc["photon_seed"], dev).fold(
                    mods.PHOTON_FOLD), pdt, caustic=cfg.include_caustics,
                global_=cfg.include_final_gather)
            if pdt != dtype:
                maps = {k: None if m is None else m._replace(**{
                    f: getattr(m, f).to(dtype) for f in m._fields
                    if torch.is_tensor(getattr(m, f))
                    and getattr(m, f).is_floating_point()})
                    for k, m in maps.items()}
            self.rt = self.rt._replace(gi_hook=mods.make_gi_hook(
                maps, cfg, live_power=True))
        counts = []
        for i in range(first):
            px, py, uv, ap, _ = self.samples(self.pixels(i), i)
            counts.append(torch.stack(mods.spawn_counts(
                self.ir, self.rt, *mods.rays_for_pixels(self.cam, px, py, uv,
                                                        ap), self.depth)))
        self.buckets = mods.quantize_buckets(
            torch.stack(counts).amax(0).tolist(), tc["margin"])
        self.params, self.static = mods.split_params(self.ir)
        self.target = None

    def pixels(self, i):
        """Step i's pixel ids."""
        if self.size == self.n:
            return torch.arange(self.n, device=self.dev)
        tg = torch.Generator(device=self.dev).manual_seed(
            g.unit_seed(self.seed, i))
        return torch.randperm(self.n, generator=tg,
                              device=self.dev)[:self.size]

    def samples(self, idx, node):
        """(px, py, uv, ap, rng) of pixel ids `idx`; `node` numbers the RNG
        node a GI batch draws from (None: the scene draws nothing)."""
        w = self.cam_desc.width
        ck = self.mods.RNG(g.unit_seed(self.seed, node), self.dev) \
            if self.gi else None
        return (*self.mods.primary_samples(self.cam_desc, self.cam, self.det,
                                           idx % w, idx // w, ck),
                None if ck is None else ck.fold(1))

    def batch(self, i):
        """(px, py, uv, ap, target, rng) of step i."""
        idx = self.pixels(i)
        px, py, uv, ap, rng = self.samples(idx, i)
        return px, py, uv, ap, self.target[idx], rng

    def n_materials(self) -> int:
        return self.params["mat_Kd"].shape[0]

    def set_target(self, factors) -> None:
        mods, kd = self.mods, self.params["mat_Kd"].detach()
        scaled = mods.merge_params(dict(self.params, mat_Kd=kd * torch.as_tensor(
            factors, dtype=kd.dtype, device=kd.device)[:, None]), self.static)
        tg = torch.Generator(device=self.dev).manual_seed(
            g.unit_seed(self.seed, -1))
        perm = torch.randperm(self.n, generator=tg, device=self.dev) \
            if self.size < self.n else torch.arange(self.n, device=self.dev)
        self.target = torch.empty((self.n, 3), dtype=kd.dtype,
                                  device=self.dev)
        for c in range(0, self.n, self.size):
            idx = perm[c:c + self.size]
            px, py, uv, ap, rng = self.samples(idx, -2 - c // self.size)
            with torch.no_grad():
                img, ovf = mods.pixel_colors(
                    scaled, self.rt, self.cam, px, py, uv, ap, 1, self.depth,
                    buckets=self.buckets, rng=rng)
            if bool(ovf):
                raise RuntimeError("the target frame overflowed its buckets")
            self.target[idx] = img

    def make_step(self, tables, remat):
        """(state, step): Adam at its default rate on `tables`, rate 0 on
        the other float tables (the backward covers them all)."""
        mods, params = self.mods, self.params
        groups = [{"params": [params[k] for k in tables]},
                  {"params": [p for k, p in params.items()
                              if k not in tables], "lr": 0.0}]
        init, step = mods.make_train_step(
            self.rt, self.cam, self.static, 1, self.depth, remat=remat,
            buckets=self.buckets, optimizer=lambda ps: mods.adam(groups))
        return init(params), step


def kd_factors(seed: int, n: int) -> np.ndarray:
    """The target's per-material mat_Kd factors, in [0.5, 0.9)."""
    return np.random.default_rng(seed).uniform(0.5, 0.9, n)


def first_steps(job, tables, remat, n):
    """Build the job's train step and take its first n Adam steps ->
    (state, step, readings): each step's loss, overflow and wall, each
    leaf's first gradient as Adam holds it after one step (its first
    moment over 1 - beta1), and each leaf's change after each step."""
    state, step = job.make_step(tables, remat)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    losses, overflow, walls, grads, change = [], [], [], {}, []
    for i in range(n):
        t0 = time.perf_counter()
        px, py, uv, ap, target, rng = job.batch(i)
        state, loss, ovf = step(state, px, py, uv, ap, target, rng=rng)
        losses.append(float(loss))
        overflow.append(bool(ovf))
        walls.append(time.perf_counter() - t0)
        if i == 0:
            opt = state.optimizer
            for k, p in state.params.items():
                st = opt.state.get(p, {})
                beta1 = next(grp["betas"][0] for grp in opt.param_groups
                             if any(q is p for q in grp["params"]))
                grads[k] = (st["exp_avg"] / (1.0 - beta1)).detach().clone() \
                    if "exp_avg" in st else torch.zeros_like(p)
        change.append({k: (state.params[k].detach() - p0[k]) for k in p0})
    return state, step, {"losses": losses, "overflow": overflow,
                         "walls": walls, "grads": grads, "change": change}


def run(ctx) -> dict:
    cfg = ctx.config
    tc = dict(cfg["train"])
    if ctx.resize and "batch_pixels" in ctx.resize:
        tc["batch_pixels"] = ctx.resize["batch_pixels"]
    dev = ctx.device
    dtype = getattr(torch, cfg["dtype"])
    if dev.type == "cuda":
        from fast_ray_tracer_tpu_torch import _build
        _build.build(*_build.CUDA_SOURCES)
    first = int(ctx.traffic["first_steps"])
    scene_file = g.stage_scene(ctx)
    job = Job(g.program_modules(), scene_file, dtype, dev, tc, ctx.seed,
              first)
    factors = kd_factors(ctx.seed, job.n_materials())
    job.set_target(factors)
    state, step, mine = first_steps(job, tc["tables"], tc["remat"], first)
    sync(dev)
    setup_peak = g.peak_bytes(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    trace = tr.Trace() if ctx.trace else None
    if ctx.trace:
        n_trace = int(cfg["trace_units"]["train"])
        expect = max(1.0, ctx.seconds / max(mine["walls"][-1], 1e-6))
        trace.every = max(1, int(round(expect / n_trace)))
    failed, steps, profiled, walls = 0, 0, 0, []
    with host.Collections() as gcs:
        before = host.snapshot()
        setup_s = time.perf_counter() - ctx.t_start
        t0 = last = time.perf_counter()
        while True:
            px, py, uv, ap, target, rng = job.batch(first + steps)
            if ctx.trace and steps % trace.every == trace.every // 2 \
                    and profiled < n_trace:
                mark = []
                with tr.profiled(trace, dev, mark):
                    state, loss, ovf = step(
                        state, px, py, uv, ap, target, rng=rng,
                        between=lambda: mark.append(time.time_ns()))
                    bad = bool(ovf) or not np.isfinite(float(loss))
                profiled += 1
            else:
                state, loss, ovf = step(state, px, py, uv, ap, target,
                                        rng=rng)
                bad = bool(ovf) or not np.isfinite(float(loss))
            failed += bad
            steps += 1
            now = time.perf_counter()
            walls.append(now - last)
            last = now
            if now - t0 >= ctx.seconds:
                break
        window = time.perf_counter() - t0
        after = host.snapshot()
    sync(dev)
    peak = g.peak_bytes(dev)
    out = {"attempted": steps, "failed": failed,
           "metrics": {"setup_s": setup_s, "step_s": window / steps,
                       "peak_mem_gib": peak / g.GIB},
           "memory_peak_bytes": max(peak, setup_peak),
           "info": dict({"steps": steps, "window_s": window,
                         "first_losses": mine["losses"],
                         "first_overflow": mine["overflow"],
                         "first_walls": mine["walls"], "step_s": walls},
                        **gcs.summary(), **host.delta(before, after))}
    if ctx.trace:
        out["trace"] = trace

    # the reference follows the first steps, once the window has closed
    del state, step, job, target
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref_job = Job(g.reference_modules(), scene_file, dtype, dev, tc,
                  ctx.seed, first)
    ref_job.set_target(factors)
    _, _, ref = first_steps(ref_job, tc["tables"], tc["remat"],
                            int(tc.get("reference_steps", first)))
    out["numbers"] = compare.train_numbers(mine, ref, tc["tables"])
    out["limits"] = cfg["limits"]["train"]
    print(f"benchmark: first steps' losses {mine['losses']} against the "
          f"reference's {ref['losses']} ({time.perf_counter() - t1:.1f} s)",
          file=sys.stderr, flush=True)
    return out


