"""The port's training module, checkpoints and PNG reader on the CPU.

- A pattern's gradient: `pat_colors` of a uv checker in a sphere's map_Kd
  slot (what tests/test_inverse.py optimizes), an inline scene at 12x6,
  depth 5, float64, every key of `split_params` against `jax.grad` to 1e-9
  of the field's largest |g| plus 1e-12.
- Checkpoints, bitwise: a saved and restored train state takes the same
  next step; a trainer killed at step 7 with saves every 3 steps resumes
  from step 6 onto the uninterrupted 12-step trajectory; a render resumed
  from a rewound snapshot is the uninterrupted render.
- The mesh guard, now a training check: Adam steps through a clustered
  mesh (Kd and vertices requiring grad) run, move the vertices and lower
  the loss, and the no-grad forward still renders the scene's frame.
- Fault C9: the port's `read_png` against the JAX package's (Pillow) on
  palette, Adam7-interlaced, 1/2/4-bit and 16-bit alpha-carrying PNGs,
  bitwise; other formats through Pillow in `read_image`.
"""

import pathlib
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from fast_ray_tracer_tpu.io import ppm as jppm

from fast_ray_tracer_tpu_torch.io import ppm as tppm
from fast_ray_tracer_tpu_torch.parallel import checkpoint as tckpt
from fast_ray_tracer_tpu_torch.parallel import train as ttrain
from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene.model import (
    ApertureDesc, CameraDesc, ConfigDesc, LightDesc, MaterialDesc,
    PatternDesc, SceneDesc, ShapeDesc,
)
from tests.grad_fixture import PARAM_KEYS, Frame, assert_grad_close

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
W, H = 12, 6


def checker_scene(width=W, height=H):
    """A sphere whose map_Kd is a uv checker through a spherical map (the
    structure of the reference's checkered_sphere scene), over a
    reflective floor with a 3-D checker, one point light."""
    P = PatternDesc
    sphere = MaterialDesc(
        color=(1.0, 1.0, 1.0), diffuse=0.8, specular=0.3, shininess=40.0,
        patterns={"map_Kd": P(kind="map", mapping="sphere", faces=[
            P(kind="uv_checker", width=8, height=4,
              colors=[(0.0, 0.5, 0.0), (1.0, 1.0, 1.0)])])})
    floor = MaterialDesc(
        specular=0.0, reflective=0.3, patterns={"map_Kd": P(
            kind="checker", colors=[(0.3, 0.3, 0.4), (0.7, 0.7, 0.6)])})
    return SceneDesc(
        camera=CameraDesc(width=width, height=height, field_of_view=0.9,
                          frm=(0.0, 1.6, -4.5), to=(0.0, 0.8, 0.0),
                          up=(0.0, 1.0, 0.0), aperture=ApertureDesc()),
        lights=[LightDesc(kind="point", at=(-4.0, 5.0, -3.0),
                          intensity=(1.0, 1.0, 1.0))],
        world=[ShapeDesc(kind="plane", material=floor),
               ShapeDesc(kind="sphere", transform=[["translate", 0, 1, 0]],
                         material=sphere)],
        config=ConfigDesc(divide_threshold=1))


@pytest.fixture(scope="module")
def pattern():
    frame = Frame(checker_scene())
    target = frame.target()
    return frame, frame.jax_grads(target), frame.port_grads(target)


@pytest.mark.parametrize("key", PARAM_KEYS)
def test_pattern_gradients_match_jax(pattern, key):
    _, (_, jgrads), (_, tgrads) = pattern
    assert np.all(np.isfinite(tgrads[key]))
    assert_grad_close(tgrads[key], jgrads[key], key)


def test_pattern_colors_get_a_gradient(pattern):
    frame, (jloss, _), (tloss, tgrads) = pattern
    assert abs(tloss - jloss) <= 1e-12 * jloss
    assert frame.ir.meta.pattern_slots, "the scene must bind a pattern"
    g = tgrads["pat_colors"]
    assert np.count_nonzero(g) >= 6


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trainer(frame, lr=5e-2):
    """Only pat_colors trains, from perturbed colors, against the frame of
    the true ones (tests/test_inverse.py's structure)."""
    target = torch.as_tensor(frame.target(1.0, 0.0))
    init, step = ttrain.make_train_step(
        frame.rt, frame.cam, frame.static, 1, frame.depth,
        optimizer=lambda ps: ttrain.adam(ps, lr=lr))

    def fresh():
        params = {k: v.detach().clone().requires_grad_(k == "pat_colors")
                  for k, v in frame.params.items()}
        with torch.no_grad():
            params["pat_colors"].mul_(0.45).add_(0.3)
        return init(params)

    def run(state, start, stop, ckpt=None, every=3):
        losses = []
        for s in range(start, stop):
            state, loss, ovf = step(state, *frame.args, target)
            assert not bool(ovf)
            losses.append(float(loss))
            if ckpt is not None and (s + 1) % every == 0:
                tckpt.save_train_state(ckpt, s + 1, state)
        return state, losses

    return fresh, run


def test_train_state_roundtrip(pattern, tmp_path):
    frame = pattern[0]
    fresh, run = _trainer(frame)
    state, _ = run(fresh(), 0, 2)
    d = str(tmp_path / "ckpt")
    tckpt.save_train_state(d, 2, state)
    assert tckpt.restore_train_state(str(tmp_path / "nope"), fresh()) is None
    step, restored = tckpt.restore_train_state(d, fresh())
    assert step == 2
    for k in PARAM_KEYS:
        assert torch.equal(restored.params[k], state.params[k]), k
    a, la = run(state, 2, 3)
    b, lb = run(restored, 2, 3)
    assert la == lb
    for k in PARAM_KEYS:
        assert torch.equal(a.params[k], b.params[k]), k


def test_trainer_resumes_on_the_same_trajectory(pattern, tmp_path):
    """Killed at step 7 with saves every 3 steps, the trainer resumes from
    step 6 and lands bitwise on the uninterrupted 12-step trajectory; the
    directory keeps the latest three saves."""
    frame = pattern[0]
    fresh, run = _trainer(frame)
    ckpt = str(tmp_path / "ckpt")
    killed, _ = run(fresh(), 0, 7, ckpt)
    del killed                                       # the kill
    assert tckpt.saved_steps(ckpt) == [3, 6]
    step, state = tckpt.restore_train_state(ckpt, fresh())
    assert step == 6
    resumed, losses_r = run(state, step, 12, ckpt)
    control, losses_c = run(fresh(), 0, 12)
    assert losses_r == losses_c[6:]
    assert losses_c[-1] < losses_c[0]
    for k in PARAM_KEYS:
        assert torch.equal(resumed.params[k], control.params[k]), k
    assert tckpt.saved_steps(ckpt) == [6, 9, 12]
    assert not list((tmp_path / "ckpt").glob("*.tmp"))


def test_render_resume_is_identical(tmp_path):
    """A render resumed from a rewound snapshot is the uninterrupted one
    (tests/test_checkpoint.py), bitwise."""
    scene = tdemo.glass_spheres(32, 16)
    kw = dict(dtype=torch.float64, chunk_pixels=128, device="cpu")
    truth = trender.render_scene(scene, **kw)
    ckpt = str(tmp_path / "render.ckpt")
    full = trender.render_scene(scene, checkpoint_path=ckpt,
                                checkpoint_every=1, **kw)
    assert np.array_equal(full, truth)
    snap = tckpt.load_render_progress(ckpt)
    assert snap["chunks_done"] == snap["total_chunks"] == 4
    canvas = snap["canvas"].copy()
    canvas[128:] = -1.0
    tckpt.save_render_progress(ckpt, canvas, 1, snap["total_chunks"])
    resumed = trender.render_scene(scene, checkpoint_path=ckpt,
                                   checkpoint_every=1, **kw)
    assert np.array_equal(resumed, truth)
    assert tckpt.load_render_progress(str(tmp_path / "none")) is None


def test_cli_checkpoint(tmp_path):
    """The command line's --checkpoint: the snapshot of the finished
    render holds every chunk, and a rerun resumes from it to the same
    files."""
    from fast_ray_tracer_tpu_torch import __main__ as tmain
    yml = ROOT / "tools" / "golden_scenes" / "csg_test.yml"
    snap = tmp_path / "render.ckpt"
    argv = [str(yml), "--device", "cpu", "--width", "16", "--height", "8",
            "--chunk", "32", "--quiet", "--ppm-only", "--checkpoint",
            str(snap)]
    assert tmain.main(argv + ["-o", str(tmp_path / "a")]) == 0
    done = tckpt.load_render_progress(str(snap))
    assert done["chunks_done"] == done["total_chunks"] == 4
    assert tmain.main(argv + ["-o", str(tmp_path / "b")]) == 0
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm") \
        .read_bytes()


# ---------------------------------------------------------------------------
# the mesh guard
# ---------------------------------------------------------------------------

def test_mesh_guard():
    """Clustered meshes under autograd, which raised before the mesh
    gradients: Adam steps over the Kd and vertex tables run, move the
    torus's vertices and lower the loss against a target rendered with
    its Kd darkened; the forward without grad renders the scene's
    frame."""
    scene = tdemo.mesh_torus(8, 4, segments=(48, 24))
    ir = tcomp.compile_scene(scene, dtype=torch.float64, device="cpu")
    assert ir.meta.use_clusters
    rt = tintg.build_statics(ir, scene.config)
    cam = tcam.build_camera(scene.camera, dtype=torch.float64, device="cpu")
    n = 8 * 4
    args = (torch.arange(8).repeat(4), torch.arange(4).repeat_interleave(8),
            torch.full((n, 2), 0.5, dtype=torch.float64),
            torch.zeros((n, 2), dtype=torch.float64))
    params, static = ttrain.split_params(ir)
    dark = dict(params, mat_Kd=params["mat_Kd"].detach() * 0.6)
    with torch.no_grad():
        target, _ = trender.pixel_colors(ttrain.merge_params(dark, static),
                                         rt, cam, *args, 1, 5)
    # Adam moves the Kd and the vertices at 1e-4; the rest stay frozen (a
    # first step would move opaque materials' mat_Tr off 0 and switch on
    # the dissolve multiply). A step of 1e-3 on every vertex entry with a
    # gradient moves a pixel's ray or shadow ray across a triangle edge
    # at this resolution and raises the loss.
    for k, p in params.items():
        p.requires_grad_(k in ("mat_Kd", "tri_p1", "tri_e1", "tri_e2"))
    init, step = ttrain.make_train_step(
        rt, cam, static, 1, 5, optimizer=lambda ps: ttrain.adam(ps, 1e-4))
    state = init(params)
    p1 = params["tri_p1"].detach().clone()
    losses = []
    for _ in range(3):
        state, loss, ovf = step(state, *args, target)
        losses.append(float(loss))
        assert not bool(ovf)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert not torch.equal(params["tri_p1"].detach(), p1)
    params = {k: torch.as_tensor(getattr(ir, k)).clone().requires_grad_(True)
              for k in params}
    with torch.no_grad():
        img, ovf = trender.pixel_colors(
            ttrain.merge_params(params, static), rt, cam, *args, 1, 5)
    img2, _ = trender.pixel_colors(ir, rt, cam, *args, 1, 5)
    assert torch.equal(img, img2) and not bool(ovf)
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0.0


# ---------------------------------------------------------------------------
# the PNG reader (fault C9)
# ---------------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _scanlines(samples, depth, filters):
    """Filtered scanlines of an (h, w, c) integer image, filter of row y
    filters[y % len(filters)], samples packed at `depth` bits."""
    h, w, c = samples.shape
    if depth == 16:
        raw = np.frombuffer(samples.astype(">u2").tobytes(), np.uint8)
        raw = raw.reshape(h, -1)
    elif depth == 8:
        raw = samples.astype(np.uint8).reshape(h, -1)
    else:
        v = samples.reshape(h, w * c).astype(np.uint8)
        bits = (v[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        bits = bits.reshape(h, -1)
        pad = (-bits.shape[1]) % 8
        raw = np.packbits(np.pad(bits, ((0, 0), (0, pad))), axis=1)
    raw = raw.astype(np.int64)
    bpp = max(1, c * depth // 8)
    out, prev = [], np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        x = raw[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        cc = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        f = filters[y % len(filters)]
        pred = [0, a, prev, (a + prev) // 2, _paeth(a, prev, cc)][f]
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


def _png(samples, depth, ctype, interlace=False, plte=None, trns=None,
         filters=(0, 1, 2, 3, 4)):
    h, w, _ = samples.shape
    if interlace:
        data = b"".join(_scanlines(samples[y0::dy, x0::dx], depth, filters)
                        for x0, y0, dx, dy in _ADAM7
                        if samples[y0::dy, x0::dx].size)
    else:
        data = _scanlines(samples, depth, filters)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + (chunk(b"PLTE", plte) if plte is not None else b"")
            + (chunk(b"tRNS", trns) if trns is not None else b"")
            + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


def _image(ctype, depth, h=11, w=13, seed=0):
    rng = np.random.default_rng(seed + 16 * ctype + depth)
    top = (1 << depth) if ctype != 3 else min(1 << depth, 200)
    return rng.integers(0, top, (h, w, _CHANNELS[ctype]))


def _check(tmp_path, samples, depth, ctype, **kw):
    plte = None
    if ctype == 3:
        plte = np.random.default_rng(depth).integers(
            0, 256, (min(1 << depth, 200), 3)).astype(np.uint8).tobytes()
    path = tmp_path / f"t{ctype}_{depth}.png"
    path.write_bytes(_png(samples, depth, ctype, plte=plte, **kw))
    got = tppm.read_png(str(path))
    want = jppm.read_png(str(path))
    assert got.shape == want.shape == samples.shape[:2] + (3,)
    assert got.dtype == np.float64
    assert np.array_equal(got, want)
    return got


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("trns", [False, True])
def test_read_png_palette(tmp_path, depth, trns):
    """Colour type 3 maps through PLTE to RGB, with or without tRNS, as
    Pillow's convert("RGB") does."""
    s = _image(3, depth)
    got = _check(tmp_path, s, depth, 3, trns=b"\x00\x80" if trns else None)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 1


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_read_png_low_bit_grey(tmp_path, depth):
    s = _image(0, depth)
    got = _check(tmp_path, s, depth, 0)
    assert got.max() == 1.0 and got.min() == 0.0


@pytest.mark.parametrize("ctype,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (3, 1), (3, 4), (3, 8),
    (4, 8), (4, 16), (2, 8), (6, 8), (6, 16)])
def test_read_png_interlaced(tmp_path, ctype, depth):
    """Adam7 PNGs read in their seven passes, at sizes where some passes
    are empty too."""
    for h, w in ((11, 13), (1, 1), (3, 2), (8, 8)):
        _check(tmp_path, _image(ctype, depth, h, w), depth, ctype,
               interlace=True)


@pytest.mark.parametrize("ctype", [4, 6])
def test_read_png_16_bit_alpha(tmp_path, ctype):
    """16-bit grey+alpha and RGBA keep their high byte over 255, as
    Pillow reads them for the JAX package."""
    s = _image(ctype, 16)
    got = _check(tmp_path, s, 16, ctype)
    want = s[..., :1].repeat(3, -1) if ctype == 4 else s[..., :3]
    assert np.array_equal(got, (want >> 8) / 255.0)


def test_read_png_interlaced_16_bit_rgb(tmp_path):
    """16-bit RGB reads at 16 bits interlaced as plain; the JAX package's
    own 16-bit RGB decoder refuses interlaced files (a difference kept:
    the port reads the format in full)."""
    s = _image(2, 16)
    plain = tmp_path / "plain.png"
    plain.write_bytes(_png(s, 16, 2))
    adam7 = tmp_path / "adam7.png"
    adam7.write_bytes(_png(s, 16, 2, interlace=True))
    got = tppm.read_png(str(adam7))
    assert np.array_equal(got, tppm.read_png(str(plain)))
    assert np.array_equal(got, jppm.read_png(str(plain)))
    assert np.array_equal(got, s / 65535.0)
    with pytest.raises(ValueError):
        jppm.read_png(str(adam7))


@pytest.mark.parametrize("fmt", ["gif", "jpg"])
def test_read_image_through_pillow(tmp_path, fmt):
    """Another format reads as the JAX package's texture path reads it:
    converted to a PNG and read back through Pillow."""
    from PIL import Image
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (9, 7, 3)).astype(np.uint8)
    src = tmp_path / f"tex.{fmt}"
    img = Image.fromarray(arr)
    (img.convert("P") if fmt == "gif" else img).save(src)
    png = tmp_path / "converted.png"
    Image.open(src).save(png)
    got = tppm.read_image(str(src))
    assert np.array_equal(got, jppm.read_png(str(png)))


def test_read_image_without_pillow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    path = tmp_path / "tex.gif"
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="tex.gif"):
        tppm.read_image(str(path))
