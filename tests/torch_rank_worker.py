"""One rank of tests/test_torch_parallel.py's two-rank runs on the CPU.

    python tests/torch_rank_worker.py RANK WORLD STORE OUT

Joins a gloo process group through the `file://` store STORE (rank RANK
of WORLD, on the CPU), runs every case below on the port alone (no jax)
and saves each case's results to OUT/<case>_<RANK>.pt:

- render: glass_spheres(32, 16) in float64, chunks of 128 pixels;
- dof: a 16x8 frame with 2x2 camera jitter and a circular aperture at
  seed 3, chunks of 32 pixels;
- train: one Adam step of test_sharding.py's set-up (32x16 float64, the
  target rendered with mat_Kd x 0.7) on this rank's shard;
- resume: glass_spheres(32, 16) in chunks of 64 with a snapshot every 2
  chunks, interrupted on every rank when chunk 2 starts (rank 1 refuses
  to write a snapshot), then rendered again from the snapshot;
- replicate: replicate_scene over a dict and a SceneIR whose values
  differ by rank.
"""

import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from fast_ray_tracer_tpu_torch.parallel import checkpoint  # noqa: E402
from fast_ray_tracer_tpu_torch.parallel import distributed  # noqa: E402
from fast_ray_tracer_tpu_torch.parallel.mesh import (  # noqa: E402
    replicate_scene, shard_pixel_batch,
)
from fast_ray_tracer_tpu_torch.parallel.train import (  # noqa: E402
    make_train_step, merge_params, split_params,
)
from fast_ray_tracer_tpu_torch.render import render  # noqa: E402
from fast_ray_tracer_tpu_torch.render.camera import build_camera  # noqa: E402
from fast_ray_tracer_tpu_torch.render.integrator import (  # noqa: E402
    build_statics,
)
from fast_ray_tracer_tpu_torch.sampling.cmj import (  # noqa: E402
    cmj_points_static,
)
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene  # noqa: E402
from fast_ray_tracer_tpu_torch.scene.demo import glass_spheres  # noqa: E402
from fast_ray_tracer_tpu_torch.scene.model import (  # noqa: E402
    ApertureDesc, replace,
)

F64 = dict(dtype=torch.float64, device="cpu")
DOF_SEED, DOF_CHUNK = 3, 32


def dof_scene():
    sc = glass_spheres(16, 8)
    sc.camera = replace(sc.camera, usteps=2, vsteps=2, aperture=ApertureDesc(
        kind="CIRCULAR_APERTURE", size=0.05, params=(1.0,), jitter=True))
    return sc


def train_setup(w=32, h=16):
    """test_sharding.py's _setup and target, on the port."""
    scene = glass_spheres(w, h)
    ir = compile_scene(scene, **F64)
    cam_rt = build_camera(scene.camera, **F64)
    rt = build_statics(ir, scene.config)
    n = w * h
    px = torch.arange(w).repeat(h)
    py = torch.arange(h).repeat_interleave(w)
    uv = torch.as_tensor(cmj_points_static(1, 1)).expand(n, 2).contiguous()
    ap = torch.zeros((n, 2), dtype=torch.float64)
    depth = scene.config.di_path_length
    params, static = split_params(ir)
    scaled = {k: v.detach() for k, v in params.items()}
    scaled["mat_Kd"] = scaled["mat_Kd"] * 0.7
    with torch.no_grad():
        target, _ = render.pixel_colors(merge_params(scaled, static), rt,
                                        cam_rt, px, py, uv, ap, 1, depth)
    return rt, cam_rt, static, depth, params, (px, py, uv, ap, target)


class Interrupted(Exception):
    pass


def resume_case(mesh, out):
    scene = glass_spheres(32, 16)
    kw = dict(chunk_pixels=64, checkpoint_every=2, mesh=mesh, **F64)
    snap = str(out / "resume.npz")
    real_colors, real_save = render.pixel_colors, render.save_render_progress
    calls = {"n": 0, "stop": 2}

    def counted(*a, **k):
        if calls["n"] == calls["stop"]:
            raise Interrupted
        calls["n"] += 1
        return real_colors(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("rank 1 wrote a render snapshot")

    render.pixel_colors = counted
    if mesh.rank == 1:
        render.save_render_progress = refuse
    try:
        render.render_scene(scene, checkpoint_path=snap, **kw)
        raise AssertionError("the render was not interrupted")
    except Interrupted:
        pass
    torch.distributed.barrier()
    done = checkpoint.load_render_progress(snap)["chunks_done"]
    calls.update(n=0, stop=-1)
    resumed = render.render_scene(scene, checkpoint_path=snap, **kw)
    render.pixel_colors, render.save_render_progress = real_colors, real_save
    return {"snapshot_chunks": done, "resumed_chunks": calls["n"],
            "canvas": resumed}


def main():
    rank, world, store, out = sys.argv[1:5]
    out = pathlib.Path(out)
    torch.set_num_threads(1)
    distributed.init(store, int(world), int(rank), local_device_ids="cpu",
                     backend="gloo")
    mesh = distributed.global_mesh()

    stats = {}
    canvas = render.render_scene(glass_spheres(32, 16), chunk_pixels=128,
                                 mesh=mesh, stats=stats, **F64)
    torch.save({"canvas": canvas, "stats": stats}, out / f"render_{rank}.pt")

    canvas = render.render_scene(dof_scene(), chunk_pixels=DOF_CHUNK,
                                 seed=DOF_SEED, mesh=mesh, **F64)
    torch.save({"canvas": canvas}, out / f"dof_{rank}.pt")

    rt, cam_rt, static, depth, params, batch = train_setup()
    init, step = make_train_step(rt, cam_rt, static, 1, depth, mesh=mesh)
    state = replicate_scene(mesh, init(params))
    state, loss, ovf = step(state, *shard_pixel_batch(mesh, *batch))
    torch.save({"loss": loss, "overflow": bool(ovf),
                "params": {k: v.detach() for k, v in state.params.items()}},
               out / f"train_{rank}.pt")

    torch.save(resume_case(mesh, out), out / f"resume_{rank}.pt")

    tree = {"a": torch.full((3,), float(rank)),
            "b": torch.arange(4) * (int(rank) + 1)}
    ir = compile_scene(glass_spheres(8, 4), **F64)
    ir.mat_Kd.add_(float(rank))
    replicate_scene(mesh, tree)
    replicate_scene(mesh, ir)
    torch.save({"tree": tree, "mat_Kd": ir.mat_Kd},
               out / f"replicate_{rank}.pt")
    distributed.shutdown()


if __name__ == "__main__":
    main()
