"""The port's image textures against the JAX package on the CPU.

- the `uv_image` lookup on seeded (u, v), inside and outside [0, 1],
  over two images of the atlas: the texels equal, and so their atlas
  indices (every texel holds its own value);
- tools/golden_scenes/mtl_test.yml, with synthetic kamen.png,
  kamen-bump.png, mramor6x6.png and mramor6x6-bump.png (the reference's
  images are not in the repo) in four PNG formats: MTL map_Ka, map_Kd and
  map_bump on smooth triangles with vt coordinates, 64x48 depth 5;
- scene/demo.soft_textured at 64x32 depth 5 with a 2,048-triangle torus
  (clustered): PNG textures through the MTL file, a 16-bit PPM on the
  floor, sampled lights, a glass sphere.
Canvases (the port's render_scene, the JAX package's trace_bucketed on
the same buckets) agree to 1e-9 in float64 (the frameworks round a pow or
a sqrt one ulp apart).
"""

import pathlib

import numpy as np
import torch

import jax.numpy as jnp

from fast_ray_tracer_tpu.ops import patterns as jpat
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel
from fast_ray_tracer_tpu.scene.yaml_loader import load_scene as jload

from fast_ray_tracer_tpu_torch.io.ppm import encode_png
from fast_ray_tracer_tpu_torch.ops import patterns as tpat
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import ir as IR
from fast_ray_tracer_tpu_torch.scene import model as tmodel
from fast_ray_tracer_tpu_torch.scene.yaml_loader import load_scene

from scene_convert import convert, jax_canvas

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "golden_scenes"


def _ppm16(path, w, h, first):
    """A 16-bit P6 image whose texels hold the distinct red values first,
    first + 1, ... in row-major order."""
    red = first + np.arange(w * h).reshape(h, w)
    px = np.stack([red, np.full_like(red, 7), 65535 - red], -1)
    path.write_bytes(f"P6\n{w} {h}\n65535\n".encode()
                     + px.astype(">u2").tobytes())


def test_uv_image_lookup_matches_jax(tmp_path):
    _ppm16(tmp_path / "a.ppm", 23, 17, 100)
    _ppm16(tmp_path / "b.ppm", 9, 5, 1000)
    pats = {"map_Kd": tmodel.PatternDesc(
        kind="map", mapping="plane", faces=[tmodel.PatternDesc(
            kind="uv_image", file="a.ppm", decode_to_linear=False)]),
        "map_bump": tmodel.PatternDesc(
            kind="map", mapping="plane", faces=[tmodel.PatternDesc(
                kind="uv_image", file="b.ppm")])}
    sc = tmodel.SceneDesc(
        camera=tmodel.CameraDesc(width=4, height=2),
        world=[tmodel.ShapeDesc(kind="plane", material=tmodel.MaterialDesc(
            patterns=pats))], root_dir=str(tmp_path))
    jir = jcomp.compile_scene(convert(sc, jmodel), dtype=jnp.float64)
    tir = tcomp.compile_scene(sc, dtype=torch.float64, device="cpu")
    for name in ("tex_data", "tex_offset", "tex_width", "tex_height",
                 "pat_tex"):
        assert np.array_equal(getattr(tir, name).numpy(),
                              np.asarray(getattr(jir, name))), name
    rng = np.random.default_rng(7)
    n = 4000
    u = np.concatenate([rng.uniform(-0.2, 1.2, n), [0, 1, 0.5, 1 - 1e-17]])
    v = np.concatenate([rng.uniform(-0.2, 1.2, n), [0, 1, 1e-17, 0.5]])
    kinds = {IR.PAT_UV_TEXTURE}
    for pid in (1, 3):          # the uv_image rows under each map
        pids = np.full(len(u), pid)
        want = np.asarray(jpat._eval_uv(jir, jnp.asarray(pids),
                                        jnp.asarray(u), jnp.asarray(v),
                                        kinds))
        got = tpat._eval_uv(tir, torch.from_numpy(pids), torch.from_numpy(u),
                            torch.from_numpy(v), kinds).numpy()
        assert np.array_equal(got, want)
        # the JAX texel's atlas row, from its distinct red value
        row = {x: i for i, x in enumerate(tir.tex_data[:, 0].tolist())}
        idx = tpat.texel_index(tir, torch.from_numpy(pids),
                               torch.from_numpy(u), torch.from_numpy(v))
        assert idx.tolist() == [row[x] for x in want[:, 0].tolist()]
        assert len(set(idx.tolist())) > 40


def _mtl_images(d):
    """Synthetic stand-ins for the reference's sibenik textures, one PNG
    format each: 8-bit RGB, 8-bit grey, 16-bit RGB, 8-bit grey+alpha."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:48, 0:64] / 64.0
    base = 0.5 + 0.3 * np.sin(2 * np.pi * (3 * x + 2 * y))[..., None] \
        * np.array([1.0, 0.8, 0.6])
    kamen = np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1)
    bump = 0.5 + 0.05 * np.sin(2 * np.pi * 5 * x) * np.cos(2 * np.pi * 4 * y)
    images = {
        "kamen.png": (kamen * 255).round().astype(np.uint8),
        "kamen-bump.png": (bump * 255).round().astype(np.uint8),
        "mramor6x6.png": (kamen[::-1, :, ::-1] * 65535).round()
        .astype(np.uint16),
        "mramor6x6-bump.png": np.stack(
            [(bump.T[:48, :48] * 255).round(), np.full((48, 48), 255)],
            -1).astype(np.uint8),
    }
    for name, a in images.items():
        (d / name).write_bytes(encode_png(a))


def _render_both(scene, w, h):
    """The port's render_scene against the JAX package's trace_bucketed
    on the port's buckets, in float64."""
    stats = {}
    got = trender.render_scene(scene, dtype=torch.float64,
                               chunk_pixels=w * h, device="cpu", stats=stats)
    assert stats["escalations"] == 0 and stats["exact_chunks"] == 0
    assert got.shape == (h, w, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_canvas(scene, stats["buckets"]),
                               rtol=0, atol=1e-9)
    return got


def test_mtl_test_canvas_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path))
    d = tmp_path / "scenes_reduced"
    d.mkdir()
    for f in ("mtl_test.obj", "mtl_test.mtl"):
        (d / f).write_bytes((GOLDEN / f).read_bytes())
    _mtl_images(d)
    yml = d / "mtl_test.yml"
    yml.write_text((GOLDEN / "mtl_test.yml").read_text()
                   .replace("{ROOT}", str(tmp_path)))
    scene = load_scene(str(yml))
    assert convert(scene, jmodel) == jload(str(yml))
    scene.camera.width, scene.camera.height = 64, 48
    ir = tcomp.compile_scene(scene, dtype=torch.float64, device="cpu")
    assert ir.tex_width.tolist() == [64, 64, 64, 48]
    assert IR.SLOT_KA in ir.meta.pattern_slots and ir.meta.any_bump
    assert not ir.meta.use_clusters and ir.meta.needs_hit_sort
    got = _render_both(scene, 64, 48)
    assert got.std() > 0.02


def test_soft_textured_canvas_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path))
    scene = tdemo.soft_textured(64, 32, segments=(32, 32))
    ir = tcomp.compile_scene(scene, dtype=torch.float64, device="cpu")
    assert ir.meta.use_clusters and ir.meta.needs_hit_sort
    assert IR.PAT_UV_TEXTURE in ir.meta.pattern_kinds
    assert ir.meta.max_light_samples == 16
    got = _render_both(scene, 64, 32)
    assert got.std() > 0.02
