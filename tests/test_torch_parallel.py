"""The port's multi-device slice on the CPU: the pixel split over
torch.distributed, the data-parallel train step, the bucket disk cache and
the profiler trace.

Two gloo ranks run in processes of their own (tests/torch_rank_worker.py),
joined through a `file://` store under the test's temporary directory,
never a fixed TCP port; each has its own 180 s limit, after which both are
killed and the test fails. One run serves every two-rank test.

- The flagship's canvas over two ranks is bitwise the port's single-device
  render (per-pixel arithmetic does not change) and within 1e-9 of the JAX
  package's render_scene on make_mesh(2).
- A stochastic frame's shards follow JAX's key tree: shard r of chunk c is
  the port's pixel_colors of those pixels from root.fold(c).fold(r).
- The train step: the two ranks' loss and parameters bitwise equal, within
  rtol 1e-12 (loss) and 1e-9 / atol 1e-12 (parameters) of the port's
  single-process step and of JAX's step jitted on make_mesh(2) with
  test_sharding.py's shardings.
- A sharded render resumed from rank 0's snapshot is the uninterrupted one.
- replicate_scene leaves rank 0's values on every rank.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.parallel import distributed as jdist
from fast_ray_tracer_tpu.parallel import mesh as jmesh
from fast_ray_tracer_tpu.parallel import train as jtrain
from fast_ray_tracer_tpu.render import render as jrender
from fast_ray_tracer_tpu.scene import demo as jdemo

from fast_ray_tracer_tpu_torch import __main__ as tmain
from fast_ray_tracer_tpu_torch.parallel import distributed as tdist
from fast_ray_tracer_tpu_torch.parallel import mesh as tmesh
from fast_ray_tracer_tpu_torch.parallel import train as ttrain
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.render.camera import build_camera
from fast_ray_tracer_tpu_torch.render.integrator import build_statics
from fast_ray_tracer_tpu_torch.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu_torch.sampling.rng import RNG
from fast_ray_tracer_tpu_torch.scene.compile import compile_scene
from fast_ray_tracer_tpu_torch.scene.demo import glass_spheres
from fast_ray_tracer_tpu_torch.utils.profiling import TRACE_FILE, trace_context
from tests import torch_rank_worker as worker
from tests.test_sharding import _setup as sharding_setup

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 180
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One two-rank run of every case: {case: [rank 0's, rank 1's]}."""
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               FRT_COMPILE_CACHE=str(out / "cache"))
    procs = []
    try:
        for r in range(2):
            log = open(out / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "torch_rank_worker.py"),
                 str(r), "2", f"file://{out / 'store'}", str(out)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT),
                log, time.monotonic() + RANK_TIMEOUT_S))
        for r, (p, log, deadline) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timed out"
            log.close()
            assert rc == 0, (f"rank {r}: {rc}\n"
                             + (out / f"rank{r}.log").read_text()[-4000:])
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return {case: [torch.load(out / f"{case}_{r}.pt", weights_only=False)
                   for r in range(2)]
            for case in ("render", "dof", "train", "resume", "replicate")}


@pytest.mark.parametrize("n", [0, 1, 7, 8, 33])
@pytest.mark.parametrize("nproc", [1, 2, 3, 8])
def test_process_shard_matches_jax(monkeypatch, n, nproc):
    """process_shard: the JAX package's arithmetic for every process id."""
    for pid in range(nproc):
        monkeypatch.setattr(jax, "process_count", lambda: nproc)
        monkeypatch.setattr(jax, "process_index", lambda: pid)
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size",
                            lambda: nproc)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda: pid)
        assert tdist.process_shard(n) == jdist.process_shard(n)


def test_sharded_render_matches_single_device_and_jax(ranks):
    """Two ranks, glass_spheres(32, 16), float64, chunks of 128 pixels:
    both canvases bitwise equal to each other and to the port's
    single-device render, within 1e-9 of JAX's render on make_mesh(2)."""
    a, b = (r["canvas"] for r in ranks["render"])
    assert np.array_equal(a, b)
    single = trender.render_scene(glass_spheres(32, 16), chunk_pixels=128,
                                  **F64)
    assert np.array_equal(a, single)
    want = jrender.render_scene(jdemo.glass_spheres(32, 16),
                                dtype=jnp.float64, chunk_pixels=128,
                                mesh=jmesh.make_mesh(2))
    np.testing.assert_allclose(a, np.asarray(want), rtol=0, atol=1e-9)
    for r in ranks["render"]:
        assert r["stats"]["escalations"] == 0
        assert r["stats"]["exact_chunks"] == 0


def test_sharded_draws_follow_jax_key_tree(ranks):
    """Two ranks, the jittered DoF frame (2x2 camera jitter, a circular
    aperture, seed 3, 16x8, chunks of 32): equal across ranks; each shard
    of each chunk bitwise the port's pixel_colors of its pixels from
    root.fold(c).fold(r), tracing from its fold(1); unlike the frame
    rendered without a mesh."""
    a, b = (r["canvas"] for r in ranks["dof"])
    assert np.array_equal(a, b)
    scene = worker.dof_scene()
    cam = scene.camera
    ir = compile_scene(scene, **F64)
    rt = build_statics(ir, scene.config)
    cam_rt = build_camera(cam, **F64)
    det = torch.as_tensor(cmj_points_static(cam.usteps, cam.vsteps))
    root = RNG(worker.DOF_SEED, "cpu")
    flat = a.reshape(-1, 3)
    shard = worker.DOF_CHUNK // 2
    for c in range(flat.shape[0] // worker.DOF_CHUNK):
        for r in range(2):
            lo = c * worker.DOF_CHUNK + r * shard
            idx = torch.arange(lo, lo + shard)
            ck = root.fold(c).fold(r)
            got, ovf = trender.pixel_colors(
                ir, rt, cam_rt, *trender.primary_samples(
                    cam, cam_rt, det, idx % cam.width, idx // cam.width, ck),
                cam.usteps * cam.vsteps, scene.config.di_path_length,
                rng=ck.fold(1))
            assert not bool(ovf)
            assert np.array_equal(flat[lo:lo + shard], got.numpy()), (c, r)
    alone = trender.render_scene(scene, chunk_pixels=worker.DOF_CHUNK,
                                 seed=worker.DOF_SEED, **F64)
    assert not np.array_equal(a, alone)


def test_sharded_train_step_matches_single_process_and_jax(ranks):
    """Two ranks, test_sharding.py's step (32x16 f64, target mat_Kd x 0.7):
    loss and parameters bitwise across ranks; within rtol 1e-12 (loss) and
    rtol 1e-9 / atol 1e-12 (parameters) of the port's single-process step
    and of JAX's make_train_step jitted on make_mesh(2)."""
    r0, r1 = ranks["train"]
    assert torch.equal(r0["loss"], r1["loss"])
    assert not r0["overflow"] and not r1["overflow"]
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k

    rt, cam_rt, static, depth, params, batch = worker.train_setup()
    init, step = ttrain.make_train_step(rt, cam_rt, static, 1, depth)
    state, loss, _ = step(init(params), *batch)
    np.testing.assert_allclose(float(r0["loss"]), float(loss), rtol=1e-12)
    for k, v in state.params.items():
        np.testing.assert_allclose(r0["params"][k].numpy(),
                                   v.detach().numpy(), rtol=1e-9, atol=1e-12,
                                   err_msg=k)

    scene, jir, jcam, jrt, (px, py, uv, ap) = sharding_setup()
    pl = scene.config.di_path_length
    jparams, jstatic = jtrain.split_params(jir)
    p2 = dict(jparams)
    p2["mat_Kd"] = jparams["mat_Kd"] * 0.7
    target = np.asarray(jax.jit(
        lambda p: jrender.pixel_colors(
            jtrain.merge_params(p, jstatic), jrt, jcam, jnp.asarray(px),
            jnp.asarray(py), jnp.asarray(uv), jnp.asarray(ap), 1, pl,
            None))(p2))
    jinit, jstep = jtrain.make_train_step(jrt, jcam, jstatic, 1, pl)
    mesh = jmesh.make_mesh(2)
    s2 = jmesh.replicate_scene(mesh, jinit(jparams))
    s2, jloss = jax.jit(jstep)(s2, *jmesh.shard_pixel_batch(
        mesh, px, py, uv, ap, target))
    np.testing.assert_allclose(float(r0["loss"]), float(jloss), rtol=1e-12)
    for k, v in s2.params.items():
        np.testing.assert_allclose(r0["params"][k].numpy(), np.asarray(v),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


def test_sharded_render_resumes_from_rank0_snapshot(ranks):
    """Interrupted when chunk 2 of 8 starts, with a snapshot every 2
    chunks that only rank 0 writes; rendered again, both ranks resume
    after chunk 2 and return the uninterrupted canvas, bitwise."""
    truth = ranks["render"][0]["canvas"]
    for r in ranks["resume"]:
        assert r["snapshot_chunks"] == 2 and r["resumed_chunks"] == 6
        assert np.array_equal(r["canvas"], truth)


def test_replicate_scene_broadcasts_rank0(ranks):
    """replicate_scene leaves rank 0's values on every rank: a dict of
    tensors and a SceneIR's tables that differed by rank."""
    r0, r1 = ranks["replicate"]
    want = glass_spheres(8, 4)
    kd = compile_scene(want, **F64).mat_Kd
    for r in (r0, r1):
        assert torch.equal(r["tree"]["a"], torch.zeros(3))
        assert torch.equal(r["tree"]["b"], torch.arange(4))
        assert torch.equal(r["mat_Kd"], kd)


def test_shard_pixel_batch():
    """Contiguous equal slices by rank; a length the mesh does not divide
    raises."""
    batch = torch.arange(12).reshape(6, 2)
    parts = [tmesh.shard_pixel_batch(
        tmesh.PixelMesh(r, 3, torch.device("cpu"), None), batch,
        np.arange(6)) for r in range(3)]
    assert torch.equal(torch.cat([p[0] for p in parts]), batch)
    assert [p[1].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError):
        tmesh.shard_pixel_batch(tmesh.PixelMesh(0, 4, torch.device("cpu"),
                                                None), batch)


# ---------------------------------------------------------------------------
# the bucket disk cache and the profiler
# ---------------------------------------------------------------------------

def _cache_file(tmp_path):
    return tmp_path / "frt_buckets.json"


def test_bucket_cache_hit_skips_the_probe(tmp_path, monkeypatch):
    """The second render of a scene reads its buckets from the cache: the
    probe never runs (spawn_counts raises), and the canvas is bitwise the
    first render's."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path))
    scene = glass_spheres(32, 16)
    first_stats, second_stats = {}, {}
    first = trender.render_scene(scene, chunk_pixels=128, stats=first_stats,
                                 **F64)
    assert list(json.loads(_cache_file(tmp_path).read_text()).values()) \
        == [list(first_stats["buckets"])]

    def no_probe(*a, **k):
        raise AssertionError("the probe ran on a cache hit")

    monkeypatch.setattr(trender, "spawn_counts", no_probe)
    second = trender.render_scene(scene, chunk_pixels=128,
                                  stats=second_stats, **F64)
    assert np.array_equal(first, second)
    assert second_stats["buckets"] == first_stats["buckets"]


def test_bucket_cache_undersized_entry_escalates(tmp_path, monkeypatch):
    """A planted undersized entry: the render escalates, renders the same
    canvas, and the entry is rewritten with the escalated buckets."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path))
    scene = glass_spheres(32, 16)
    want = trender.render_scene(scene, chunk_pixels=128, **F64)
    entries = json.loads(_cache_file(tmp_path).read_text())
    (key, good), = entries.items()
    _cache_file(tmp_path).write_text(json.dumps({key: [8] * len(good)}))
    stats = {}
    got = trender.render_scene(scene, chunk_pixels=128, stats=stats, **F64)
    assert stats["escalations"] >= 1
    assert np.array_equal(got, want)
    rewritten = json.loads(_cache_file(tmp_path).read_text())[key]
    assert rewritten == list(stats["buckets"]) and min(rewritten) > 8


def test_bucket_cache_key_follows_the_scene():
    """The key changes with a material and with the camera's samples a
    pixel (the flagship and its DoF variant share every table), and not
    from one compile of the same scene to the next."""
    def key(scene):
        ir = compile_scene(scene, **F64)
        return trender._bucket_cache_key(ir, scene.config, scene.camera,
                                         128, torch.float64, 5)
    want = key(glass_spheres(32, 16))
    assert key(glass_spheres(32, 16)) == want
    scene = glass_spheres(32, 16)
    scene.world[0].material.reflective += 0.1
    assert key(scene) != want
    assert key(glass_spheres(32, 16, usteps=2, vsteps=2)) != want


def test_bucket_cache_unwritable_still_renders(tmp_path, monkeypatch):
    """A cache directory that cannot be made (its parent is a file): the
    render runs as without a cache."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(blocker / "cache"))
    scene = glass_spheres(16, 8)
    got = trender.render_scene(scene, chunk_pixels=64, **F64)
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path / "ok"))
    assert np.array_equal(got, trender.render_scene(scene, chunk_pixels=64,
                                                    **F64))


def test_trace_context(tmp_path):
    """trace_context(None) records nothing; trace_context(dir) around an
    8x4 CPU render writes a Chrome trace naming aten operators."""
    with trace_context(None):
        pass
    assert not list(tmp_path.iterdir())
    with trace_context(str(tmp_path / "prof")):
        trender.render_scene(glass_spheres(8, 4), **F64)
    events = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_cli_profile(tmp_path, monkeypatch, capsys):
    """`--profile DIR` on the CPU: the render's four phase lines
    (compile_scene, probe_buckets, render_chunks and the command line's
    render), the trace file, and its path printed."""
    monkeypatch.setenv("FRT_COMPILE_CACHE", str(tmp_path / "cache"))
    yml = tmp_path / "scene.yml"
    yml.write_text(CLI_SCENE)
    prof = tmp_path / "prof"
    assert tmain.main([str(yml), "-o", str(tmp_path / "out"), "--device",
                       "cpu", "--profile", str(prof)]) == 0
    lines = capsys.readouterr().out.splitlines()
    phases = [json.loads(x)["phase"] for x in lines if x.startswith("{")]
    assert phases == ["compile_scene", "probe_buckets", "render_chunks",
                      "render"]
    assert "chunk 1/1" in lines
    assert f"profiler trace in {prof}" in lines
    assert (prof / TRACE_FILE).stat().st_size > 0
    assert (tmp_path / "out.ppm").exists()


CLI_SCENE = """\
- add: camera
  width: 12
  height: 6
  field-of-view: 1.0
  from: [0, 1.5, -5]
  to: [0, 1, 0]
  up: [0, 1, 0]
- add: light
  at: [-10, 10, -10]
  intensity: [1, 1, 1]
- add: plane
  material:
    color: [0.9, 0.9, 0.9]
    reflective: 0.3
- add: sphere
  transform:
  - [translate, 0, 1, 0]
  material:
    color: [0.8, 0.3, 0.2]
    reflective: 0.5
"""
