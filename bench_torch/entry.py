"""Entry points on the port: a forward step, and a multi-rank dry run.

    python3 -m bench_torch.entry

runs `entry()`'s step once and then `dryrun_multichip(n)` over every card
(n = torch.cuda.device_count()), as `python __graft_entry__.py` does for
the JAX package.

- `entry(device=None) -> (fn, args)`: the 64x32 `glass_spheres` float32
  forward step through the port's `pixel_colors` (depth 5, the unrolled
  trace); `fn(*args)` returns the port's `(colors, overflow)`.
- `dryrun_multichip(n, device=None)`: one Adam step over every float table
  with the 16x8 pixel batch split over n ranks (padded to a multiple of
  n) through `shard_pixel_batch` and `replicate_scene`, then the sharded
  `render_scene(mesh=, chunk_pixels=16 * n)`. The ranks are processes of
  their own (bench_torch/ranks.py): NCCL with one rank per card where
  there are n cards, else gloo ranks sharing the cards (printed), and
  gloo on the CPU for `device="cpu"`.
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.parallel.mesh import (
    replicate_scene, shard_pixel_batch,
)
from fast_ray_tracer_tpu_torch.parallel.train import (
    make_train_step, split_params,
)
from fast_ray_tracer_tpu_torch.render.camera import build_camera
from fast_ray_tracer_tpu_torch.render.integrator import build_statics
from fast_ray_tracer_tpu_torch.render.render import pixel_colors, render_scene
from fast_ray_tracer_tpu_torch.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.demo import glass_spheres

from bench_torch import ranks


def resolve(device) -> torch.device:
    """`device` (None: the CUDA card) as a torch.device; raises when the
    card is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device; the CPU runs only "
                           "when asked for (device='cpu')")
    return device


def _setup(width, height, device, dtype=torch.float32):
    scene = glass_spheres(width, height)
    ir = compile_scene(scene, dtype=dtype, device=device)
    cam_rt = build_camera(scene.camera, dtype=dtype, device=device)
    return scene, ir, cam_rt, build_statics(ir, scene.config)


def _pixels(width, height, n, device, dtype=torch.float32):
    """Row-major pixel ids of the frame, padded with pixel (0, 0) to n,
    the 1x1 subpixel table and point-aperture offsets."""
    px = torch.arange(width).repeat(height)
    py = torch.arange(height).repeat_interleave(width)
    pad = n - px.shape[0]
    px = torch.cat([px, torch.zeros(pad, dtype=px.dtype)]).to(device)
    py = torch.cat([py, torch.zeros(pad, dtype=py.dtype)]).to(device)
    uv = torch.as_tensor(cmj_points_static(1, 1), dtype=dtype).to(device) \
        .expand(n, 2)
    return px, py, uv, torch.zeros((n, 2), dtype=dtype, device=device)


def entry(device=None):
    """(fn, args): the forward render step of the flagship glass_spheres
    scene (Whitted depth 5, reflect and refract) at 64x32 in float32."""
    device = resolve(device)
    scene, ir, cam_rt, rt = _setup(64, 32, device)
    depth = scene.config.di_path_length

    def fn(ir_in, px, py, uv, ap):
        return pixel_colors(ir_in, rt, cam_rt, px, py, uv, ap, 1, depth)

    return fn, (ir, *_pixels(64, 32, 64 * 32, device))


def _dryrun_rank(mesh, out):
    """One rank of dryrun_multichip: the step, then the sharded render;
    rank 0 leaves the canvas in `out`."""
    scene, ir, cam_rt, rt = _setup(16, 8, mesh.device)
    depth = scene.config.di_path_length
    n = -(-16 * 8 // mesh.size) * mesh.size
    px, py, uv, ap = _pixels(16, 8, n, "cpu")
    target = torch.zeros((n, 3), dtype=torch.float32)
    params, static = split_params(ir)
    init, step = make_train_step(rt, cam_rt, static, 1, depth, mesh=mesh)
    state = replicate_scene(mesh, init(params))
    state, loss, overflow = step(state, *shard_pixel_batch(
        mesh, px, py, uv.contiguous(), ap, target))
    loss = float(loss)
    finite = all(bool(torch.isfinite(p).all())
                 for p in state.params.values())
    canvas = render_scene(scene, dtype=torch.float32,
                          chunk_pixels=16 * mesh.size, mesh=mesh)
    if mesh.rank == 0:
        np.save(os.path.join(out, "canvas.npy"), canvas)
    return {"loss": loss, "params_finite": finite, "overflow": bool(overflow),
            "n_params": len(state.params),
            "canvas_finite": bool(np.isfinite(canvas).all()),
            "canvas_shape": list(canvas.shape)}


def dryrun_multichip(n: int, device=None) -> dict:
    """The training step and the sharded render over n ranks; prints the
    JAX version's two lines and returns {"loss", "canvas", "placement"}.
    Raises on a non-finite loss, parameter or canvas."""
    device = resolve(device)
    where, res, out = ranks.spawn("bench_torch.entry:_dryrun_rank", n, device)
    try:
        canvas = np.load(os.path.join(out, "canvas.npy"))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    r0 = res[0]
    if not np.isfinite(r0["loss"]):
        raise AssertionError(f"non-finite loss {r0['loss']}")
    if not all(r["params_finite"] for r in res):
        raise AssertionError("non-finite params after update")
    if not all(r["canvas_finite"] for r in res):
        raise AssertionError("non-finite sharded canvas")
    if where["shared"]:
        print(f"dryrun_multichip({n}): {n} {where['backend']} ranks share "
              f"{torch.cuda.device_count()} card(s)", flush=True)
    print(f"dryrun_multichip({n}): loss={r0['loss']:.6f} over "
          f"{r0['n_params']} param tensors OK", flush=True)
    print(f"dryrun_multichip({n}): sharded render {tuple(canvas.shape)} OK",
          flush=True)
    return {"loss": r0["loss"], "canvas": canvas, "placement": where}


def main() -> int:
    fn, args = entry()
    colors, overflow = fn(*args)
    print("entry forward:", tuple(colors.shape), colors.dtype,
          bool(torch.isfinite(colors).all()), "overflow", bool(overflow),
          flush=True)
    dryrun_multichip(torch.cuda.device_count())
    return 0


if __name__ == "__main__":
    sys.exit(main())
