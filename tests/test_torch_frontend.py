"""The port's scene frontend against the JAX package on the CPU: the YAML
loader, the input color decode, the PNG writer, the PNG and PPM readers,
and the command line.

Tolerances: the loaded scene descriptions are equal field for field (the
repo's golden scenes and scene/demo.soft_textured's YAML); XYZ and LAB
decode to 1e-12 (both float64: numpy here, jnp under x64 there); the PNG
writer's bytes are equal; the readers are bitwise equal on every format
both read in full (8-bit grey, grey+alpha, RGB and RGBA through Pillow on
the JAX side, 16-bit grey, 16-bit RGB through its own decoder), with each
of the five scanline filters, and on 16-bit grey+alpha and RGBA, which
both read at 8 bits (Pillow's truncation, ROADMAP C9; palette, interlaced
and low-bit-depth PNGs are held in tests/test_torch_train.py). Its loader raises ValueError on malformed pattern colors, where the
JAX loader raises KeyError, IndexError or TypeError, or loads them (C4).
The command line's PPMs agree to 1 of 65535 per channel.
"""

import json
import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from fast_ray_tracer_tpu import __main__ as jmain
from fast_ray_tracer_tpu import colors as jcolors
from fast_ray_tracer_tpu.io import ppm as jppm
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel
from fast_ray_tracer_tpu.scene import yaml_loader as jyaml

from fast_ray_tracer_tpu_torch import __main__ as tmain
from fast_ray_tracer_tpu_torch import colors as tcolors
from fast_ray_tracer_tpu_torch.io import ppm as tppm
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import model as tmodel
from fast_ray_tracer_tpu_torch.scene import yaml_loader as tyaml

from scene_convert import convert

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tools" / "golden_scenes"


def _golden_copy(name, tmp_path):
    """tools/golden_scenes/<name>.yml with {ROOT} set to tmp_path, in
    tmp_path/scenes_reduced/ beside mtl_test's OBJ and MTL files."""
    d = tmp_path / "scenes_reduced"
    d.mkdir(exist_ok=True)
    for f in ("mtl_test.obj", "mtl_test.mtl"):
        (d / f).write_bytes((GOLDEN / f).read_bytes())
    path = d / f"{name}.yml"
    path.write_text((GOLDEN / f"{name}.yml").read_text()
                    .replace("{ROOT}", str(tmp_path)))
    return str(path)


@pytest.mark.parametrize("name", ["csg_test", "csg_obj_test", "mtl_test",
                                  "soft_textured"])
def test_load_scene_matches_jax(name, tmp_path):
    """The port's load_scene equals the JAX package's field for field;
    soft_textured() equals its own YAML loaded."""
    if name == "soft_textured":
        scene = tdemo.soft_textured()
        path = str(tdemo.SOFT_DIR / "soft_textured.yml")
        assert tyaml.load_scene(path) == scene
    else:
        path = _golden_copy(name, tmp_path)
    got = tyaml.load_scene(path)
    assert got == convert(jyaml.load_scene(path), tmodel)
    assert convert(got, jmodel) == jyaml.load_scene(path)
    assert got.camera is not None and got.world


@pytest.mark.parametrize("colors,jax_error", [
    (None, KeyError), ([[1, 0, 0]], IndexError), ("red", None),
    ([[1, 0, 0], 5], TypeError), ([[1, 0, 0], [0, 1]], None)])
def test_malformed_colors_raise_value_error(colors, jax_error, tmp_path):
    """Fault C4: a pattern's colors indexed without a guard. The port's
    loader raises ValueError; the JAX loader raises KeyError, IndexError
    or TypeError, or loads colors that are no triples (None here), the
    divergence this test records."""
    pattern = {"type": "stripes"}
    if colors is not None:
        pattern["colors"] = colors
    tree = [{"add": "sphere", "material": {"pattern": pattern}}]
    with pytest.raises(ValueError, match="colors"):
        tyaml.scene_from_tree(tree)
    path = tmp_path / "bad.yml"
    path.write_text(json.dumps(tree))
    if jax_error is None:
        sc = jyaml.load_scene(str(path))
        colors = sc.world[0].material.patterns["map_Kd"].colors
        assert any(len(c) != 3 for c in colors)
    else:
        with pytest.raises(jax_error):
            jyaml.load_scene(str(path))


def test_load_scene_refuses_python_tags(tmp_path):
    """A scene file is parsed with the safe loader: a `!!python/...` tag
    raises in the port, where the JAX loader's full CLoader (taken when
    libyaml is present) calls the function it names (ROADMAP C4)."""
    path = tmp_path / "tagged.yml"
    path.write_text("- add: camera\n"
                    "  width: !!python/object/apply:builtins.len [[1, 2]]\n"
                    "  height: 2\n  field-of-view: 1.0\n"
                    "  from: [0, 0, -5]\n  to: [0, 0, 0]\n"
                    "  up: [0, 1, 0]\n")
    with pytest.raises(yaml.YAMLError, match="python/object/apply"):
        tyaml.load_scene(str(path))
    if yaml.__with_libyaml__:
        assert jyaml.load_scene(str(path)).camera.width == 2


def test_rgb_to_srgb_matches_jax():
    """The one sRGB encode (the PPM and PNG writers') against the JAX
    package's colors.rgb_to_srgb on finite values, negatives included;
    NaN stays NaN, as in the C code, where the JAX function gives 1."""
    rng = np.random.default_rng(7)
    c = np.concatenate([rng.uniform(-0.5, 1.5, 509),
                        [0.0, 0.0031308, np.nextafter(0.0031308, 0), 1.0]])
    np.testing.assert_allclose(tcolors.rgb_to_srgb(c),
                               np.asarray(jcolors.rgb_to_srgb(jnp.asarray(c))),
                               rtol=0, atol=1e-15)
    assert np.isnan(tcolors.rgb_to_srgb(np.array([np.nan]))).all()


@pytest.mark.parametrize("space", ["XYZ", "LAB", "HSL", "SRGB"])
def test_color_decode_matches_jax(space):
    """The input decode, standalone and as compile_scene's, against the
    JAX package's in float64, on seeded colors of each space's range."""
    rng = np.random.default_rng(4)
    c = rng.uniform([0, -80, -80], [100, 80, 80], (257, 3)) \
        if space == "LAB" else rng.uniform(0, 1, (257, 3))
    want = np.asarray(jcolors.INPUT_DECODE[space](jnp.asarray(c)))
    got = tcolors.INPUT_DECODE[space](c)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tcomp._np_decode(space)(c),
                               jcomp._np_decode(space)(c), rtol=0, atol=1e-12)


def test_lab_decode_is_float64_for_a_float32_frame():
    """Fault C8: the port decodes in float64 whatever the frame's dtype;
    one LAB red reaches the float32 material table as the float32 cast of
    the float64 decode."""
    lab = (53.2408, 80.0925, 67.2032)
    sc = tmodel.SceneDesc(
        camera=tmodel.CameraDesc(width=4, height=2),
        world=[tmodel.ShapeDesc(kind="sphere", material=tmodel.MaterialDesc(
            color=lab, ambient=1.0))],
        config=tmodel.ConfigDesc(color_space="LAB"))
    ir = tcomp.compile_scene(sc, dtype=torch.float32, device="cpu")
    want = tcolors.lab_to_rgb(np.asarray(lab)).astype(np.float32)
    assert np.array_equal(ir.mat_Ka[0].numpy(), want)


def test_write_png_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    canvas = rng.uniform(-0.2, 1.3, (13, 21, 3))
    tppm.write_png(canvas, tmp_path / "t")
    jppm.write_png(canvas, str(tmp_path / "j"))
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_bytes(samples, filters, ctype, interlace=0, plte=b""):
    """A PNG of (H, W, C) uint8/uint16 samples whose scanline y is
    filtered with filters[y % len(filters)] (PNG spec section 9)."""
    h, w, c = samples.shape
    depth = 16 if samples.dtype == np.uint16 else 8
    raw = np.frombuffer(samples.astype(">u2" if depth == 16 else np.uint8)
                        .tobytes(), np.uint8).reshape(h, -1).astype(np.int64)
    bpp = c * depth // 8
    out, prev = [], np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        x = raw[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        cc = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        f = filters[y % len(filters)]
        pred = [0, a, prev, (a + prev) // 2, _paeth(a, prev, cc)][f]
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prev = x

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + (chunk(b"PLTE", plte) if plte else b"")
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


_FORMATS = {"grey8": (1, np.uint8, 0), "grey_alpha8": (2, np.uint8, 4),
            "rgb8": (3, np.uint8, 2), "rgba8": (4, np.uint8, 6),
            "rgb16": (3, np.uint16, 2)}


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
def test_read_png_matches_jax(fmt, tmp_path):
    """Each format with every filter type alone and all five mixed by
    row, bitwise against the JAX read_png, with and without a decode."""
    c, dt, ctype = _FORMATS[fmt]
    rng = np.random.default_rng(len(fmt))
    samples = rng.integers(0, np.iinfo(dt).max + 1, (11, 17, c)).astype(dt)
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        path = tmp_path / f"{fmt}_{''.join(map(str, filters))}.png"
        path.write_bytes(_png_bytes(samples, filters, ctype))
        want = jppm.read_png(str(path))
        got = tppm.read_png(str(path))
        assert got.shape == (11, 17, 3) and got.dtype == np.float64
        assert np.array_equal(got, want), (fmt, filters)
        dec = jcomp._np_decode("SRGB")
        assert np.array_equal(tppm.read_png(str(path), decode=dec),
                              jppm.read_png(str(path), decode=dec))


def test_encode_png_round_trips(tmp_path):
    """encode_png's files read back to their samples, and write_png's to
    the samples png16 gives."""
    rng = np.random.default_rng(2)
    for fmt, (c, dt, _) in _FORMATS.items():
        s = rng.integers(0, np.iinfo(dt).max + 1, (5, 9, c)).astype(dt)
        p = tmp_path / f"{fmt}.png"
        p.write_bytes(tppm.encode_png(s))
        want = s[..., :1].repeat(3, -1) if c <= 2 else s[..., :3]
        got = tppm.read_png(str(p)) * np.iinfo(dt).max
        assert np.array_equal(np.round(got), want)
    canvas = rng.uniform(0, 1.2, (6, 7, 3))
    tppm.write_png(canvas, tmp_path / "w")
    assert np.array_equal(
        np.round(tppm.read_png(str(tmp_path / "w.png")) * 65535),
        tppm.png16(canvas))


def _scanlines(png: bytes) -> list:
    """The decompressed scanlines of a single-IDAT PNG."""
    i = png.index(b"IDAT")
    (length,) = struct.unpack(">I", png[i - 4:i])
    h = struct.unpack(">I", png[20:24])[0]
    raw = zlib.decompress(png[i + 4:i + 4 + length])
    n = len(raw) // h
    return [raw[y * n:(y + 1) * n] for y in range(h)]


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
def test_encode_png_adaptive(fmt, tmp_path):
    """encode_png(adaptive=True) gives each row the filter whose bytes,
    read as signed, have the least absolute sum, and its files read back
    bitwise through both packages' readers."""
    c, dt, ctype = _FORMATS[fmt]
    y, x = np.mgrid[0:23, 0:19]
    rng = np.random.default_rng(8 + c)
    smooth = (x * 7 + y * 5) * (np.iinfo(dt).max // 300)
    s = (smooth[..., None] + rng.integers(0, 9, (23, 19, c))
         * (y[..., None] % 3 == 0)).astype(dt)
    png = tppm.encode_png(s, adaptive=True)
    rows = _scanlines(png)
    each = [_scanlines(_png_bytes(s, [f], ctype)) for f in range(5)]

    def score(line):
        v = np.frombuffer(line[1:], np.uint8).astype(np.int64)
        return np.minimum(v, 256 - v).sum()

    for yy, line in enumerate(rows):
        scores = [score(e[yy]) for e in each]
        assert line[0] == int(np.argmin(scores)) and line == each[line[0]][yy]
    assert len({line[0] for line in rows}) > 1
    path = tmp_path / f"{fmt}.png"
    path.write_bytes(png)
    want = s[..., :1].repeat(3, -1) if c <= 2 else s[..., :3]
    got = tppm.read_png(str(path))
    assert np.array_equal(got, want / float(np.iinfo(dt).max))
    assert np.array_equal(got, jppm.read_png(str(path)))


def test_read_png_refuses_unknown_filter(tmp_path):
    png = bytearray(_png_bytes(np.zeros((3, 4, 3), np.uint8), [0], 2))
    i = png.index(b"IDAT")
    lines = zlib.decompress(bytes(png[i + 4:]))
    body = lines[:26] + b"\x05" + lines[27:]
    payload = zlib.compress(body)
    head = bytes(png[:i - 4]) + struct.pack(">I", len(payload))
    chunk = b"IDAT" + payload
    path = tmp_path / "bad.png"
    path.write_bytes(head + chunk
                     + struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF)
                     + struct.pack(">I", 0) + b"IEND"
                     + struct.pack(">I", zlib.crc32(b"IEND") & 0xFFFFFFFF))
    with pytest.raises(ValueError, match="filter type 5 on scanline 2 in"):
        tppm.read_png(str(path))


@pytest.mark.parametrize("fmt", ["grey16", "grey_alpha16", "rgba16"])
def test_read_png_16_bit_other_formats(fmt, tmp_path):
    """16-bit grey, grey+alpha and RGBA, bitwise the JAX package's read:
    grey at all 16 bits; the formats with alpha at their high byte over
    255, as Pillow reads them for the JAX package (fault C9)."""
    c = {"grey16": 1, "grey_alpha16": 2, "rgba16": 4}[fmt]
    s = np.random.default_rng(c).integers(0, 65536, (9, 13, c)) \
        .astype(np.uint16)
    path = tmp_path / f"{fmt}.png"
    path.write_bytes(_png_bytes(s, [0, 1, 2, 3, 4], {1: 0, 2: 4, 4: 6}[c]))
    got = tppm.read_png(str(path))
    want = s[..., :1].repeat(3, -1) if c <= 2 else s[..., :3]
    want = want / 65535.0 if c == 1 else (want >> 8) / 255.0
    assert np.array_equal(got, want)
    assert np.array_equal(got, jppm.read_png(str(path)))


@pytest.mark.parametrize("kind", ["palette", "interlaced"])
def test_read_png_refuses_palette_and_interlaced(kind, tmp_path):
    """The reader reads palette and Adam7 PNGs (fault C9), and refuses the
    malformed ones: a palette at 16 bits, an unknown interlace method."""
    s = np.zeros((4, 4, 1 if kind == "palette" else 3), np.uint16)
    path = tmp_path / f"{kind}.png"
    if kind == "palette":
        path.write_bytes(_png_bytes(s, [0], 3, plte=bytes(range(6))))
    else:
        path.write_bytes(_png_bytes(s.astype(np.uint8), [0], 2, interlace=2))
    match = "palette at 16 bits" if kind == "palette" else "interlace method 2"
    with pytest.raises(ValueError, match=match):
        tppm.read_png(str(path))


@pytest.mark.parametrize("kind", ["p6_8", "p6_16", "ascii"])
def test_read_ppm_matches_jax(kind, tmp_path):
    rng = np.random.default_rng(3)
    if kind == "p6_8":
        v = rng.integers(0, 256, (7, 5, 3))
        data = b"P6\n5 7\n255\n" + v.astype(np.uint8).tobytes()
    elif kind == "p6_16":
        v = rng.integers(0, 65536, (7, 5, 3))
        data = b"P6\n5 7\n65535\n" + v.astype(">u2").tobytes()
    else:
        # the reference's variant: a P6 header over ASCII numbers
        v = rng.integers(0, 256, (7, 5, 3))
        data = b"P6\n5 7\n255\n" + " ".join(map(str, v.ravel())).encode()
    path = tmp_path / f"{kind}.ppm"
    path.write_bytes(data)
    got = tppm.read_ppm(str(path))
    assert np.array_equal(got, jppm.read_ppm(str(path)))
    assert np.array_equal(got, v / (255.0 if kind != "p6_16" else 65535.0))


@pytest.mark.parametrize("first", [32, 9, 10, 13])
@pytest.mark.parametrize("depth", [8, 16])
def test_read_ppm_keeps_a_whitespace_first_sample(first, depth, tmp_path):
    """Binary samples start exactly one whitespace byte past maxval, so a
    first sample (or, at 16 bits, its high byte) that is a whitespace byte
    is read, with trailing bytes after the pixels; the JAX reader drops
    it and raises or shifts the image by a byte (ROADMAP C10)."""
    v = np.random.default_rng(first).integers(0, 256, (3, 4, 3))
    v[0, 0, 0] = first
    if depth == 16:
        v = v * 256 + 7
        data = b"P6\n4 3\n65535\n" + v.astype(">u2").tobytes()
    else:
        data = b"P6\n4 3\n255\n" + v.astype(np.uint8).tobytes()
    path = tmp_path / "w.ppm"
    path.write_bytes(data + b"\n")
    maxval = 255.0 if depth == 8 else 65535.0
    assert np.array_equal(tppm.read_ppm(str(path)), v / maxval)
    try:
        jax_got = jppm.read_ppm(str(path))
    except ValueError:
        return
    assert not np.array_equal(jax_got, v / maxval)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

CLI_SCENE = """
- add: config
  output:
    color-space: SRGB
- add: camera
  width: 40
  height: 20
  field-of-view: 1.0
  from: [0.0, 1.5, -5.0]
  to: [0.0, 0.5, 0.0]
  up: [0.0, 1.0, 0.0]
- add: light
  corner: [-2.0, 4.0, -3.0]
  uvec: [1.0, 0.0, 0.0]
  vvec: [0.0, 0.0, 1.0]
  usteps: 2
  vsteps: 2
  intensity: [0.8, 0.8, 0.8]
- add: light
  at: [3.0, 5.0, 0.0]
  to: [0.0, 0.0, 0.0]
  intensity: [0.3, 0.3, 0.3]
- add: plane
  material:
    patterns:
      Kd:
        type: map
        mapping: planar
        uv_pattern:
          type: image
          file: tex.ppm
- add: sphere
  transform:
  - [translate, 0, 1, 0]
  material:
    color: [0.8, 0.3, 0.2]
"""


def test_cli_matches_jax(tmp_path, monkeypatch):
    """`python -m` of both packages on a 16x8 scene with an area light, a
    hemisphere light and a PPM texture, in float64 on the CPU: the PPMs
    decode to within 1 of 65535 per channel, and both write a PNG."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path / "cache"))
    rng = np.random.default_rng(5)
    (tmp_path / "tex.ppm").write_bytes(
        b"P6\n8 8\n255\n" + rng.integers(0, 256, (8, 8, 3))
        .astype(np.uint8).tobytes())
    yml = tmp_path / "scene.yml"
    yml.write_text(CLI_SCENE)
    size = ["--width", "16", "--height", "8", "--dtype", "f64", "--quiet"]
    assert tmain.main([str(yml), "-o", str(tmp_path / "t"), "--device",
                       "cpu"] + size) == 0
    assert jmain.main([str(yml), "-o", str(tmp_path / "j"), "--platform",
                       "cpu"] + size) == 0
    imgs = []
    for stem in ("t", "j"):
        data = (tmp_path / f"{stem}.ppm").read_bytes()
        assert data.startswith(b"P6\n16 8\n65535\n")
        imgs.append(np.frombuffer(data[len(b"P6\n16 8\n65535\n"):-1], ">u2")
                    .astype(np.int64))
        assert (tmp_path / f"{stem}.png").exists()
    assert np.abs(imgs[0] - imgs[1]).max() <= 1
    assert imgs[0].std() > 1000


def test_cli_refuses_without_cuda(tmp_path):
    """Without --device cpu the command line renders on the card: on a
    machine without one it raises, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "tex.ppm").write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    yml = tmp_path / "scene.yml"
    yml.write_text(CLI_SCENE)
    with pytest.raises((AssertionError, RuntimeError)):
        tmain.main([str(yml), "-o", str(tmp_path / "t"), "--quiet"])
    assert not (tmp_path / "t.ppm").exists()


def test_cli_on_golden_scene(tmp_path):
    """The acceptance command: csg_test.yml at 32x16 on the CPU writes
    both files."""
    stem = tmp_path / "x"
    assert tmain.main([str(GOLDEN / "csg_test.yml"), "-o", str(stem),
                       "--device", "cpu", "--width", "32", "--height", "16",
                       "--quiet"]) == 0
    img = tppm.read_png(str(stem) + ".png")
    assert img.shape == (16, 32, 3)
    assert (tmp_path / "x.ppm").read_bytes().startswith(b"P6\n32 16\n")
