"""The port's row gather from small tables (`ops/gather.take_rows`) on the
CPU: its gradient against plain indexing's, its plain path, its routing
by table size, its launch counter, and whole train-step gradients in
every remat mode against the plain route's.

On the CPU the backward is `table_grad_ref` (`index_add_` into zeros,
lane order), so in float64 it agrees with ATen's backward of `table[idx]`
to 1e-12 of the field's largest |g| (bitwise in practice: both add in
lane order). The CUDA kernel is held to it on the card by chip_smoke.py.
"""

import dataclasses
import pathlib

import pytest
import torch

from fast_ray_tracer_tpu_torch.ops import gather
from fast_ray_tracer_tpu_torch.parallel import train as ttrain
from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.yaml_loader import load_scene

torch.set_num_threads(1)

SCENE = (pathlib.Path(__file__).resolve().parent.parent / "benchmark"
         / "scenes" / "reflect_refract.yml")
K = 7
TRAILING = ((), (3,), (4, 4), (5, 3))
RTOL = 1e-12


def _index(kind, n=257, k=K):
    g = torch.Generator().manual_seed(3)
    if kind == "empty":
        return torch.zeros(0, dtype=torch.int64)
    if kind == "repeated":
        # every row many times over
        return torch.randint(0, k, (n,), generator=g)
    if kind == "absent":
        # rows 1 and k - 1 never taken
        idx = torch.randint(0, k - 1, (n,), generator=g)
        return torch.where(idx == 1, 0, idx)
    if kind == "negative":
        # counted from the end, as in table[idx]
        return torch.randint(-k, k, (n,), generator=g)
    if kind == "strided":
        # a column of an (n, 2) index table
        return torch.randint(0, k, (n, 2), generator=g)[:, 1]
    raise ValueError(kind)


def _table(trailing, k=K, dtype=torch.float64):
    g = torch.Generator().manual_seed(5)
    return torch.randn((k, *trailing), generator=g, dtype=dtype)


def _grads(fn, table, idx):
    """(output, gradient of <output, c>) for a fixed random cotangent c."""
    t = table.detach().clone().requires_grad_(True)
    out = fn(t, idx)
    c = torch.randn(out.shape, generator=torch.Generator().manual_seed(9),
                    dtype=out.dtype)
    (g,) = torch.autograd.grad(out, t, c)
    return out.detach(), g


def _close(got, want):
    assert got.shape == want.shape
    if not want.numel():
        return
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= RTOL * scale + 1e-300


@pytest.fixture(autouse=True)
def _fresh_counts():
    gather.LAUNCHES.update(table_grad=0, table_grad_plain=0)
    yield


@pytest.mark.parametrize("trailing", TRAILING, ids=str)
@pytest.mark.parametrize("kind", ["repeated", "absent", "negative",
                                  "strided", "empty"])
def test_gradient_matches_indexing(trailing, kind):
    table, idx = _table(trailing), _index(kind)
    out, g = _grads(gather.take_rows, table, idx)
    want_out, want_g = _grads(lambda t, i: t[i], table, idx)
    assert torch.equal(out, want_out)
    _close(g, want_g)
    if kind == "absent":
        assert not g[1].any() and not g[K - 1].any()
    # on the CPU the plain version runs: no kernel call, no large route
    assert gather.LAUNCHES == {"table_grad": 0, "table_grad_plain": 0}


@pytest.mark.parametrize("trailing", TRAILING, ids=str)
def test_backward_node_saves_only_the_index(trailing):
    table = _table(trailing).requires_grad_(True)
    idx = _index("repeated")
    out = gather.take_rows(table, idx)
    assert type(out.grad_fn).__name__ == "_TakeRowsBackward"
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].data_ptr() == idx.data_ptr()


@pytest.mark.parametrize("trailing", TRAILING, ids=str)
@pytest.mark.parametrize("how", ["no_grad", "frozen"])
def test_plain_path_is_indexing(trailing, how):
    table, idx = _table(trailing), _index("repeated")
    if how == "no_grad":
        table.requires_grad_(True)
        with torch.no_grad():
            out = gather.take_rows(table, idx)
    else:
        out = gather.take_rows(table, idx)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, table.detach()[idx])
    assert gather.LAUNCHES == {"table_grad": 0, "table_grad_plain": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("past", [False, True], ids=["at_cap", "past_cap"])
def test_route_follows_table_size(dtype, past):
    """A table of MAX_TABLE_BYTES takes the segmented sum; one row more
    keeps indexing's own backward, counted in table_grad_plain."""
    esize = torch.empty((), dtype=dtype).element_size()
    rows = gather.MAX_TABLE_BYTES // (16 * esize) + past
    table = _table((4, 4), k=rows, dtype=dtype).requires_grad_(True)
    idx = _index("repeated", k=rows)
    out = gather.take_rows(table, idx)
    name = type(out.grad_fn).__name__
    assert name == ("IndexBackward0" if past else "_TakeRowsBackward")
    assert gather.LAUNCHES == {"table_grad": 0, "table_grad_plain": int(past)}
    _, g = _grads(gather.take_rows, table, idx)
    _, want = _grads(lambda t, i: t[i], table, idx)
    assert torch.equal(g, want)


def test_wide_rows_keep_indexing():
    """A row wider than one block of the kernel keeps indexing's backward,
    however few bytes the table holds."""
    table = _table((gather.MAX_ROW + 1,), k=2).requires_grad_(True)
    out = gather.take_rows(table, _index("repeated", k=2))
    assert type(out.grad_fn).__name__ == "IndexBackward0"
    assert gather.LAUNCHES == {"table_grad": 0, "table_grad_plain": 1}


def test_table_grad_plain_sums_in_lane_order():
    """The plain version, table_grad_ref, adds each row's lanes in order."""
    g = torch.tensor([[1.0], [1e-17], [-1.0], [1e-17]], dtype=torch.float64)
    idx = torch.tensor([0, 0, 0, 2])
    got = gather.table_grad_ref(g, idx, torch.Size((3, 1)))
    # ((1 + 1e-17) - 1) in lane order is 0; row 2 takes lane 3 alone
    assert got[:, 0].tolist() == [0.0, 0.0, 1e-17]


def test_second_derivative_refused():
    table = _table((3,)).requires_grad_(True)
    out = gather.take_rows(table, _index("repeated"))
    (g,) = torch.autograd.grad(out.sum(), table, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), table)


def test_table_grad_refuses_other_devices():
    g = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no table_grad"):
        gather.table_grad(g, torch.zeros(4, dtype=torch.int64,
                                         device="meta"), torch.Size((2, 3)))


@pytest.fixture(scope="module")
def step_frame():
    """reflect_refract (its patterns in their slots) at 16x8, float64."""
    sc = load_scene(str(SCENE))
    w, h = 16, 8
    cam = dataclasses.replace(sc.camera, width=w, height=h)
    ir = compile_scene(sc, dtype=torch.float64, device="cpu")
    rt = tintg.build_statics(ir, sc.config)
    cam_rt = tcam.build_camera(cam, dtype=torch.float64, device="cpu")
    n = w * h
    args = (torch.arange(w).repeat(h), torch.arange(h).repeat_interleave(w),
            torch.as_tensor(cmj_points_static(1, 1)).expand(n, 2),
            torch.zeros((n, 2), dtype=torch.float64))
    depth = sc.config.di_path_length
    with torch.no_grad():
        img, _ = trender.pixel_colors(ir, rt, cam_rt, *args, 1, depth)
    params, static = ttrain.split_params(ir)
    return (rt, cam_rt, args, depth, img * 0.9 + 0.01, params, static,
            tintg.default_buckets(n, depth))


def _step_grads(frame, remat):
    rt, cam_rt, args, depth, target, params, static, buckets = frame
    p = {k: v.detach().clone().requires_grad_(True) for k, v in
         params.items()}
    img, ovf = trender.pixel_colors(ttrain.merge_params(p, static), rt,
                                    cam_rt, *args, 1, depth, remat=remat,
                                    buckets=buckets)
    assert not bool(ovf)
    loss = torch.mean((img - target) ** 2)
    keys = sorted(p)
    gs = torch.autograd.grad(loss, [p[k] for k in keys], allow_unused=True)
    return {k: torch.zeros_like(p[k]) if g is None else g
            for k, g in zip(keys, gs)}


@pytest.mark.parametrize("remat", ["none", "level", "nested", "dots"])
def test_train_step_gradients_unchanged(step_frame, remat, monkeypatch):
    """A whole bucketed step's gradients through take_rows equal those of
    plain indexing (every table on the large route), in each remat mode;
    every gather of the small tables takes the segmented sum."""
    got = _step_grads(step_frame, remat)
    assert gather.LAUNCHES["table_grad_plain"] == 0
    monkeypatch.setattr(gather, "MAX_TABLE_BYTES", -1)
    want = _step_grads(step_frame, remat)
    assert gather.LAUNCHES["table_grad_plain"] > 0
    moved = 0
    for k in want:
        _close(got[k], want[k])
        moved += bool(want[k].numel() and want[k].abs().max() > 0)
    # the materials, the primitives' transforms, the patterns' colors and
    # the light all carry gradient in this frame
    assert moved >= 8
