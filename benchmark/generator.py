"""What every traffic loop shares: the inputs drawn from a seed, the
scene staged from the configuration's files, and the two sides' modules.

A traffic mix is a data file, benchmark/traffic/<mix>.json, of the
parameters that its loop reads; its `loop` names the loop, the module
benchmark/loops/<loop>.py, whose `run(ctx)` drives one run (see
harness.py). A new mix of an existing loop is a new data file; a new kind
of loop is a new module beside the others.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import torch

GIB = 2**30


def unit_seed(seed: int, i: int) -> int:
    """The i-th seed drawn from `seed` (a frame of a set, a step's batch)."""
    h = hashlib.blake2b(repr((int(seed), int(i))).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 2


def load_module(root: str, path: str, name: str = None):
    """The Python file `path` (relative to the checkout's root) as a module;
    its name may hold dots."""
    name = name or "benchmark._loaded." + path.replace("/", "_").replace(
        ".", "_")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merge(into: dict, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _merge(into[k], v)
        else:
            into[k] = v


def stage_scene(ctx) -> str:
    """The configuration's scene file, staged in the checkout's
    build/benchmark/scenes/<config>/, where the loader resolves the files
    it names; returns the staged copy's path.

    - `scene_set` of the configuration, then of `ctx.resize` (the tests'
      small runs only, staged in <config>.small/): {add: {key: value}},
      each deep-merged into the scene's entries whose `add` is that name
      (a camera's size, a config's photon count).
    - `objects`: {file name: generator}, each generator a Python file
      under the benchmark whose `write(path)` writes that file beside the
      staged scene (once: it is deterministic)."""
    cfg = ctx.config
    resize = getattr(ctx, "resize", None) or {}
    sets = [s for s in (cfg.get("scene_set"), resize.get("scene_set")) if s]
    out = os.path.join(ctx.root, "build", "benchmark", "scenes",
                       cfg["name"] + (".small" if resize else ""))
    os.makedirs(out, exist_ok=True)
    dst = os.path.join(out, os.path.basename(cfg["scene"]))
    src = os.path.join(ctx.root, cfg["scene"])
    if sets:
        import yaml
        with open(src) as f:
            tree = yaml.safe_load(f)
        for s in sets:
            for entry in tree:
                if entry.get("add") in s:
                    _merge(entry, s[entry["add"]])
        with open(dst, "w") as f:
            json.dump(tree, f)
    else:
        shutil.copyfile(src, dst)
    for name, gen in cfg.get("objects", {}).items():
        path = os.path.join(out, name)
        if not os.path.exists(path):
            load_module(ctx.root, gen).write(path)
    return dst


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def install(readers, hook: str, arg):
    """Each reader's `hook(arg)`, where it has one -> their undo calls."""
    undo = []
    for r in readers:
        fn = getattr(r, hook, None)
        if fn is not None:
            undo.append(fn(arg))
    return undo


def uninstall(undo) -> None:
    for u in reversed(undo):
        if u is not None:
            u()


def program_modules():
    from fast_ray_tracer_tpu_torch.parallel import train as T
    from fast_ray_tracer_tpu_torch.render import camera as C
    from fast_ray_tracer_tpu_torch.render import integrator as I
    from fast_ray_tracer_tpu_torch.render import photon as P
    from fast_ray_tracer_tpu_torch.render import render as R
    from fast_ray_tracer_tpu_torch.sampling import cmj, rng
    from fast_ray_tracer_tpu_torch.scene import compile as S
    from fast_ray_tracer_tpu_torch.scene import yaml_loader as Y
    return _modules(T, C, I, P, R, cmj, rng, S, Y)


def reference_modules():
    from benchmark.reference.frt.parallel import train as T
    from benchmark.reference.frt.render import camera as C
    from benchmark.reference.frt.render import integrator as I
    from benchmark.reference.frt.render import photon as P
    from benchmark.reference.frt.render import render as R
    from benchmark.reference.frt.sampling import cmj, rng
    from benchmark.reference.frt.scene import compile as S
    from benchmark.reference.frt.scene import yaml_loader as Y
    return _modules(T, C, I, P, R, cmj, rng, S, Y)


def _modules(T, C, I, P, R, cmj, rng, S, Y):
    return SimpleNamespace(
        load_scene=Y.load_scene, compile_scene=S.compile_scene,
        build_statics=I.build_statics, spawn_counts=I.spawn_counts,
        build_camera=C.build_camera, rays_for_pixels=C.rays_for_pixels,
        cmj_points_static=cmj.cmj_points_static, RNG=rng.RNG,
        primary_samples=R.primary_samples, PHOTON_FOLD=R.PHOTON_FOLD,
        trace_photons=P.trace_photons, make_gi_hook=P.make_gi_hook,
        quantize_buckets=R.quantize_buckets, pixel_colors=R.pixel_colors,
        split_params=T.split_params, merge_params=T.merge_params,
        make_train_step=T.make_train_step, adam=T.adam)
