"""The port's host C++ (fast_ray_tracer_tpu_torch/native/) and its
fallback: where the C++ walks cannot be built, `native.available()` is
False after one warning, `compile_scene` takes the Python OBJ scan and
divide walk and compiles the same tables bit for bit, and `read_png`,
whose scanline unfilter has no Python version, raises naming the build.

These compare the port with itself; tests/test_torch_mesh.py holds the
Python walks against the C++ and the JAX package."""

import shutil
import warnings

import numpy as np
import pytest
import torch

from fast_ray_tracer_tpu_torch import _build, native
from fast_ray_tracer_tpu_torch.io.ppm import encode_png, read_png
from fast_ray_tracer_tpu_torch.scene import compile as tcomp
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import divide as tdiv
from fast_ray_tracer_tpu_torch.scene import obj_loader as tobj
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR

torch.set_num_threads(1)

SEGMENTS = (48, 32)          # 3,072 triangles: the smallest meshes cluster
COMPILER_LINE = "divide_core.cpp:1:1: error: expected declaration"


def _build_fails(error):
    """A _build.load whose native build raises `error`."""
    load = _build.load

    def fake(name):
        if name == "native":
            raise error
        return load(name)
    return fake


def _reset(monkeypatch):
    """The port's native availability untried again, and the OBJ scan
    cache empty; the test's monkeypatch restores both."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_failure", "")
    monkeypatch.setattr(tobj, "_GEO_CACHE", {})


@pytest.fixture
def no_native(monkeypatch):
    """The native build patched to fail as g++ reports a compile error;
    yields the warnings of the first availability check."""
    _reset(monkeypatch)
    monkeypatch.setattr(_build, "load", _build_fails(RuntimeError(
        f"build failed: native (exit 1):\n{COMPILER_LINE}\n1 error")))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert not native.available()
    return caught


def _compile(scene):
    return tcomp.compile_scene(scene, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("glass", [False, True])
def test_fallback_compiles_the_same_tables(glass, monkeypatch):
    """mesh_torus through the Python OBJ scan and divide walk compiles to
    the native build's tables bitwise, the shadow ranks included."""
    scene = tdemo.mesh_torus(64, 32, glass=glass, segments=SEGMENTS)
    _reset(monkeypatch)
    assert native.available()
    want = _compile(scene)

    _reset(monkeypatch)
    monkeypatch.setattr(_build, "load", _build_fails(RuntimeError(
        f"build failed: native (exit 1):\n{COMPILER_LINE}")))
    calls = []
    python_walk = tdiv.shadow_ranks_python
    monkeypatch.setattr(tdiv, "shadow_ranks_python",
                        lambda *a: calls.append(1) or python_walk(*a))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = _compile(scene)
    assert not native.available() and calls == [1]
    assert len(caught) == 1
    assert got.meta == want.meta
    assert got.meta.n_triangles == 2 * SEGMENTS[0] * SEGMENTS[1]
    for field in SceneIR.table_names():
        a, b = getattr(got, field), getattr(want, field)
        if a is None or b is None:
            assert a is None and b is None, field
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), field
    assert torch.equal(got.prim_shadow_rank, want.prim_shadow_rank)


def test_one_warning_names_the_compiler_line(no_native):
    """The failed build warns once, with the compiler's first line; later
    checks stay quiet and stay False."""
    assert len(no_native) == 1
    assert issubclass(no_native[0].category, RuntimeWarning)
    assert COMPILER_LINE in str(no_native[0].message)
    with warnings.catch_warnings(record=True) as again:
        warnings.simplefilter("always")
        assert not native.available()
        assert not native.available()
    assert again == []


def test_read_png_raises_naming_the_build(no_native, tmp_path):
    """Without the build, reading a PNG raises a RuntimeError that names
    the C++ build (the unfilter has no Python version in the port)."""
    path = tmp_path / "t.png"
    rng = np.random.default_rng(0)
    path.write_bytes(encode_png(rng.integers(0, 65536, (4, 5, 3))
                                .astype(np.uint16)))
    with pytest.raises(RuntimeError, match="native/.*g\\+\\+") as e:
        read_png(str(path))
    assert COMPILER_LINE in str(e.value)


def test_direct_native_calls_raise_without_the_build(no_native, tmp_path):
    """parse_obj and shadow_ranks of native/ raise, naming the build;
    their callers in the scene compiler check available() first."""
    path = tdemo.write_torus_obj(tmp_path / "t.obj", 8, 4)
    with pytest.raises(RuntimeError, match="C\\+\\+ OBJ scan"):
        native.parse_obj(path)
    root = tdiv.Node(kind="group", transform=list(tdiv.IDENTITY))
    with pytest.raises(RuntimeError, match="C\\+\\+ divide walk"):
        native.shadow_ranks(root, 1, 0)


def test_missing_gxx_falls_back(monkeypatch, tmp_path):
    """No g++ on PATH and nothing built yet: the build's OSError is
    caught, one warning names it, and the OBJ scan takes the Python
    scanner with the same geometry."""
    path = tdemo.write_torus_obj(tmp_path / "t.obj", 12, 8)
    want = native.parse_obj(path)
    _reset(monkeypatch)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.delitem(_build._loaded, "native", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert not native.available()
    assert len(caught) == 1 and "g++" in str(caught[0].message)
    geo = tobj._scan_obj_python(path)
    for k in ("v", "vn", "tri", "use_n", "use_t", "group", "event"):
        np.testing.assert_array_equal(getattr(geo, k), getattr(want, k),
                                      err_msg=k)


def test_available_where_gxx_exists(monkeypatch):
    """With g++ present the C++ walks build, and compile_scene takes
    them."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    _reset(monkeypatch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert native.available()
    assert caught == []
    monkeypatch.setattr(tdiv, "shadow_ranks_python", None)   # never called
    ir = _compile(tdemo.mesh_torus(16, 8, segments=SEGMENTS))
    assert ir.meta.n_triangles == 2 * SEGMENTS[0] * SEGMENTS[1]
