"""Command-line renderer: a YAML scene to a 16-bit PPM and a 48-bit PNG.

    python -m fast_ray_tracer_tpu_torch scene.yml [-o STEM] [options]

The port's counterpart of `python -m fast_ray_tracer_tpu`: it loads the
reference-schema YAML scene (PyYAML), renders it on the CUDA card (or on
the CPU with `--device cpu`; nothing falls back), and writes STEM.ppm and
STEM.png (STEM defaults to the scene's `output.file`). Scenes that need
random numbers (jittered cameras or lights, shaped apertures) or photon
GI raise NotImplementedError, as render_scene does.

`main(argv)` parses the arguments and loads the scene; `render_to_files`
is the rest, for a caller that holds a SceneDesc.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.io.ppm import write_png, write_ppm
from fast_ray_tracer_tpu_torch.render.render import render_scene
from fast_ray_tracer_tpu_torch.scene.model import SceneDesc, replace
from fast_ray_tracer_tpu_torch.scene.yaml_loader import load_scene
from fast_ray_tracer_tpu_torch.utils.profiling import (
    PhaseTimer, rays_per_second,
)


def render_to_files(scene: SceneDesc, out: str, dtype=None,
                    chunk_pixels: Optional[int] = None, device="cuda",
                    quiet: bool = False, ppm: bool = True, png: bool = True,
                    stats: Optional[dict] = None,
                    checkpoint: Optional[str] = None) -> np.ndarray:
    """Render `scene` on `device` and write `<out>.ppm` and `<out>.png`
    (each unless switched off); returns the canvas. `dtype` defaults to
    float32 on the card and float64 on the CPU; `chunk_pixels` to the
    whole frame (render_scene still cuts chunks to its shadow-ray cap).
    `stats`, if a dict, receives render_scene's bucket statistics;
    `checkpoint` is render_scene's snapshot path (resume after a kill)."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    cam = scene.camera
    W, H = cam.width, cam.height
    timer = PhaseTimer()
    with timer.phase("render"):
        canvas = render_scene(scene, dtype=dtype,
                              chunk_pixels=chunk_pixels or W * H,
                              device=device, stats=stats,
                              checkpoint_path=checkpoint)
    wall = timer.total()
    if not quiet:
        rays = rays_per_second(W * H, cam.usteps * cam.vsteps, 2, wall)
        print(f"rendered {W}x{H} in {wall:.2f}s "
              f"({W * H / max(wall, 1e-9):,.0f} px/s, {rays:,.0f} rays/s "
              f"lower-bound) on {device.type}")
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
    ap.add_argument("--quiet", action="store_true",
                    help="print nothing but errors")
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
                    checkpoint=args.checkpoint)
    return 0


if __name__ == "__main__":
    sys.exit(main())
