"""Command-line renderer: a YAML scene to a 16-bit PPM and a 48-bit PNG.

    python -m fast_ray_tracer_tpu_torch scene.yml [-o STEM] [options]

The port's counterpart of `python -m fast_ray_tracer_tpu`: it loads the
reference-schema YAML scene (PyYAML), renders it on the CUDA card (or on
the CPU with `--device cpu`; nothing falls back), and writes STEM.ppm and
STEM.png (STEM defaults to the scene's `output.file`). Scenes that need
random numbers (jittered cameras or lights, shaped apertures, photon GI)
draw them from `--seed` (default 0): the same seed writes the same files.

With `--profile DIR` the render runs under torch.profiler with the
port's tracer on: a Chrome trace in DIR/trace.json, where the render's
spans (utils/profiling.py) are ranges above their kernels, the spans and
the host-sync counters in DIR/spans.json, and the render's phases printed
as JSON lines.

`main(argv)` parses the arguments and loads the scene; `render_to_files`
is the rest, for a caller that holds a SceneDesc.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.io.ppm import write_png, write_ppm
from fast_ray_tracer_tpu_torch.render.render import render_scene
from fast_ray_tracer_tpu_torch.scene.model import SceneDesc, replace
from fast_ray_tracer_tpu_torch.scene.yaml_loader import load_scene
from fast_ray_tracer_tpu_torch.utils.profiling import (
    PhaseTimer, rays_per_second, trace_context,
)


def render_to_files(scene: SceneDesc, out: str, dtype=None,
                    chunk_pixels: Optional[int] = None, device="cuda",
                    quiet: bool = False, ppm: bool = True, png: bool = True,
                    stats: Optional[dict] = None,
                    checkpoint: Optional[str] = None,
                    seed: Optional[int] = None,
                    profile: Optional[str] = None) -> np.ndarray:
    """Render `scene` on `device` and write `<out>.ppm` and `<out>.png`
    (each unless switched off); returns the canvas. `dtype` defaults to
    float32 on the card and float64 on the CPU; `chunk_pixels` to the
    whole frame (render_scene still cuts chunks to its shadow-ray cap).
    `stats`, if a dict, receives render_scene's bucket statistics;
    `checkpoint` is render_scene's snapshot path (resume after a kill);
    `seed` render_scene's seed. With `profile` (a directory) the render
    runs under `trace_context(profile)` and its phases, and the whole
    render's wall (`render`), are printed as JSON lines. Unless `quiet`, each chunk prints its progress."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    cam = scene.camera
    W, H = cam.width, cam.height
    timer = PhaseTimer()
    t0 = time.perf_counter()
    with trace_context(profile):
        canvas = render_scene(scene, dtype=dtype,
                              chunk_pixels=chunk_pixels or W * H,
                              device=device, stats=stats,
                              checkpoint_path=checkpoint, seed=seed,
                              timer=timer, progress=not quiet)
    wall = time.perf_counter() - t0
    timer.phases.append({"phase": "render", "seconds": wall})
    if not quiet:
        rays = rays_per_second(W * H, cam.usteps * cam.vsteps, 2, wall)
        print(f"rendered {W}x{H} in {wall:.2f}s "
              f"({W * H / max(wall, 1e-9):,.0f} px/s, {rays:,.0f} rays/s "
              f"lower-bound) on {device.type}")
    if profile:
        timer.report()
        if not quiet:
            print(f"profiler trace in {profile}")
    if ppm:
        write_ppm(canvas, out)
        if not quiet:
            print(f"wrote {out}.ppm")
    if png:
        write_png(canvas, out)
        if not quiet:
            print(f"wrote {out}.png")
    return canvas


def main(argv=None, stats: Optional[dict] = None) -> int:
    """The command line; `stats` as in render_to_files."""
    ap = argparse.ArgumentParser(
        prog="python -m fast_ray_tracer_tpu_torch",
        description="Render a reference-schema YAML scene to a 16-bit PPM "
                    "and a 48-bit PNG with the PyTorch port.")
    ap.add_argument("scene", help="YAML scene file (reference schema, "
                    "define/extend included)")
    ap.add_argument("-o", "--output", default=None,
                    help="output path stem (default: the scene's "
                    "output.file); .ppm and .png are appended")
    ap.add_argument("--width", type=int, default=None,
                    help="override the camera width")
    ap.add_argument("--height", type=int, default=None,
                    help="override the camera height")
    ap.add_argument("--dtype", choices=("f32", "f64"), default=None,
                    help="compute dtype (default: f32 on cuda, f64 on cpu)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="pixels per chunk (default: the whole frame, cut "
                    "to the renderer's shadow-ray cap)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to render (default cuda; nothing falls "
                    "back to the CPU)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="snapshot path: resumable render progress (a "
                    "killed render restarts where it stopped)")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed of the random numbers of a stochastic scene "
                    "(default 0; a deterministic scene draws none)")
    ap.add_argument("--quiet", action="store_true",
                    help="print nothing but errors (and, with --profile, "
                    "the phase lines)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="print the render's phases as JSON lines and "
                    "write a torch.profiler Chrome trace (trace.json) and "
                    "the render's spans and host-sync counts (spans.json) "
                    "into DIR")
    ap.add_argument("--ppm-only", action="store_true")
    ap.add_argument("--png-only", action="store_true")
    args = ap.parse_args(argv)

    scene = load_scene(args.scene)
    if scene.camera is None:
        print("error: scene has no camera", file=sys.stderr)
        return 2
    if args.width or args.height:
        scene.camera = replace(scene.camera,
                               width=args.width or scene.camera.width,
                               height=args.height or scene.camera.height)
    dtype = {None: None, "f32": torch.float32,
             "f64": torch.float64}[args.dtype]
    render_to_files(scene, args.output or scene.config.output_file,
                    dtype=dtype, chunk_pixels=args.chunk, device=args.device,
                    quiet=args.quiet, ppm=not args.png_only,
                    png=not args.ppm_only, stats=stats,
                    checkpoint=args.checkpoint, seed=args.seed,
                    profile=args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
