"""`correct` comes out true for the program as it stands and false for
the control and for each fault a frames cell can have, planted in the
timed path underneath a whole run (the harness's look for a card
skipped), at the tests' small sizes on the CPU."""

import json

import pytest
import torch

from fast_ray_tracer_tpu_torch.parallel import train as T
from fast_ray_tracer_tpu_torch.render import render as R

from benchmark import control

from conftest import GI_CELLS, SMALL, small_run

CELLS = ["reflect_refract.frames", "cornell_gi.frames"]
TRAIN_CELLS = ["reflect_refract.train", "cornell_gi.train"]
CONFIG_FILES = {"reflect_refract": "benchmark/configs/reflect_refract.json",
                "cornell_gi": "benchmark/tests/cornell_gi.json"}


def _root(cell, request):
    """The checkout a cell runs from: the GI cells' adds them."""
    return request.getfixturevalue("gi_root") if cell in GI_CELLS \
        else request.getfixturevalue("root")


@pytest.mark.parametrize("cell", CELLS + TRAIN_CELLS)
def test_sound_run_is_correct(cell, request):
    r = small_run(cell, root=_root(cell, request))
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("config,loop", [("reflect_refract", "frames"),
                                         ("cornell_gi", "frames"),
                                         ("reflect_refract", "train"),
                                         ("cornell_gi", "train")])
def test_control_fails(config, loop, capsys):
    """The reference in bfloat16 put in the program's place fails a
    limit, on three seeds."""
    small = SMALL[config]
    seeds = ["0", "1", "2"] if loop == "frames" else \
        ["3000000101", "3000000102", "3000000103"]
    cam = small["scene_set"]["camera"]
    argv = ["--config", CONFIG_FILES[config], "--loop", loop, "--seeds",
            *seeds, "--device", "cpu", "--resolution", str(cam["width"]),
            str(cam["height"])]
    if "config" in small["scene_set"]:
        # the chip's control: photons in float32, the rest in bfloat16
        gi = small["scene_set"]["config"]["illumination"][
            "global-illumination"]
        argv += ["--photons", str(gi["photon-count"]),
                 "--photon-dtype", "float32"]
    if loop == "train" and "batch_pixels" in small:
        argv += ["--batch", str(small["batch_pixels"])]
    assert control.main(argv) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 3
    assert not any(ln["passes"] for ln in lines), lines


def _scaled(factor):
    orig = R.pixel_colors

    def pixel_colors(*a, **k):
        colors, ovf = orig(*a, **k)
        return colors * factor, ovf
    return pixel_colors


def _half_left_out(*a, **k):
    colors, ovf = _half_left_out.orig(*a, **k)
    keep = torch.arange(colors.shape[0], device=colors.device) % 2 == 0
    return torch.where(keep[:, None], colors, 0.0), ovf


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_fault_fails(cell, fault, monkeypatch, request):
    if fault == "answer_altered":
        monkeypatch.setattr(R, "pixel_colors", _scaled(1.02))
    else:
        _half_left_out.orig = R.pixel_colors
        monkeypatch.setattr(R, "pixel_colors", _half_left_out)
    r = small_run(cell, root=_root(cell, request))
    assert r["correct"] is False, r["checks"]


def test_stale_frame_fails(monkeypatch, gi_root):
    """A GI frame answered with an earlier frame's canvas (another seed's
    photons and gather) fails."""
    orig = R.render_scene
    first = []

    def render_scene(*a, **k):
        out = orig(*a, **k)
        if not first:
            first.append(out)
        return first[0]
    monkeypatch.setattr(R, "render_scene", render_scene)
    r = small_run("cornell_gi.frames", root=gi_root)
    assert r["correct"] is False, r["checks"]


def _make_step_with(transform):
    orig = T.make_train_step

    def make_train_step(*a, **k):
        init, step = orig(*a, **k)

        def faulty(state, px, py, uv, ap, target, **kw):
            return step(state, *transform(px, py, uv, ap, target), **kw)
        return init, faulty
    return make_train_step


def _no_update(*a, **k):
    """A step that returns its state unchanged: the forward and backward
    run, Adam does not."""
    init, step = _no_update.orig(*a, **k)

    def frozen(state, *args, **kw):
        saved = state.optimizer.step
        state.optimizer.step = lambda *x, **y: None
        try:
            return step(state, *args, **kw)
        finally:
            state.optimizer.step = saved
    return init, frozen


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_train_fault_fails(cell, fault, monkeypatch, request):
    if fault == "state_unchanged":
        _no_update.orig = T.make_train_step
        monkeypatch.setattr(T, "make_train_step", _no_update)
    elif fault == "half_left_out":
        def half(*xs):
            n = xs[0].shape[0] // 2
            return tuple(x[:n] for x in xs)
        monkeypatch.setattr(T, "make_train_step", _make_step_with(half))
    else:
        monkeypatch.setattr(T, "pixel_colors", _scaled(1.02))
    r = small_run(cell, root=_root(cell, request))
    assert r["correct"] is False, r["checks"]
