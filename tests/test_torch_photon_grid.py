"""The port's photon map, built on the device over the occupied cells
alone, against the JAX package's dense grid (run unedited as the oracle),
on the CPU in float64:

- seeded photon clouds with far strays (photons that left the scene): the
  grid's origin, cell size and dims are the JAX map's; the estimate is
  within 1e-9 of the JAX package's and of the brute-force oracle, `found`
  exact; max_neighbors is the dense grid's (the JAX package's 27-shift
  sum over its cells' counts), attained in an empty cell between two
  full ones; queries fall in empty cells beside full ones, outside the
  grid and parked at 1e30;
- a stray cloud whose dense grid would need over 1,000 cells a photon:
  the map's tables hold the occupied cells alone;
- a 24x24 Cornell GI frame (2,000 photons, 2x2 gather, 2x2 spp, a 2x2
  jittered area light, no block) through render_scene, against the
  benchmark's frozen reference (benchmark/reference/frt, the dense host
  grid) to 1e-9.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_ray_tracer_tpu.render import photon as jph

from fast_ray_tracer_tpu_torch.render import photon as tph
from fast_ray_tracer_tpu_torch.render import render as trender
from fast_ray_tracer_tpu_torch.scene import demo as tdemo
from fast_ray_tracer_tpu_torch.scene import yaml_loader as tyaml

from test_torch_photon import _oracle, jax_map_arrays

torch.set_num_threads(1)

F64 = torch.float64
RADIUS, NUM, CONE_K = 0.25, 40, 1.0


def _cloud(seed):
    """A box of photons, a few far strays, and two clusters two cells
    apart far from both, with every photon's power and direction."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (2000, 3)) * [1.0, 0.3, 1.0]
    stray = rng.choice(len(pos), 30, replace=False)
    pos[stray] *= rng.uniform(8, 30, (30, 1))
    # two clusters of 150 photons, each inside one cell, two cells apart
    # on the grid's lattice (past every other photon, so the grid's origin
    # stays the box's): the largest block is the empty cell's between them
    origin = pos.min(axis=0) - 1e-6
    c0 = origin + np.ceil((40.0 - origin) / RADIUS) * RADIUS
    a = c0 + rng.uniform(0.02, 0.2, (150, 3))
    b = a + [2 * RADIUS, 0.0, 0.0]
    pos = np.concatenate([pos, a, b])
    n = len(pos)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return pos, rng.uniform(0, 1, (n, 3)), dirs, c0


def _dense_counts(pos, origin, dims):
    """Each dense cell's photons, by the JAX map's grid."""
    cell = np.minimum(np.floor((pos - np.asarray(origin)) / RADIUS)
                      .astype(np.int64), np.asarray(dims) - 1)
    cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    return np.bincount(cid, minlength=int(np.prod(dims))).reshape(dims)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_map_matches_the_dense_grid(seed):
    pos, power, dirs, c0 = _cloud(seed)
    jpm = jph.build_photon_map(pos, power, dirs, RADIUS, jnp.float64)
    tpm = tph.build_photon_map(pos, power, dirs, RADIUS, F64, "cpu")
    assert tpm.n == len(pos) == jpm.n
    assert tpm.dims == tuple(jpm.dims)
    assert tpm.grid_origin == tuple(jpm.grid_origin)
    assert tpm.cell_size == jpm.cell_size
    counts = _dense_counts(pos, jpm.grid_origin, tpm.dims)
    assert tpm.cell_keys.numel() == np.count_nonzero(counts)
    assert tpm.max_neighbors == jph._neighborhood_row_max(counts) == 300

    rng = np.random.default_rng(100 + seed)
    pts = rng.uniform(-1, 1, (300, 3)) * [1.0, 0.3, 1.0]
    # the empty cell between the clusters, an empty cell beside the first
    # cluster's, a stray's neighbourhood, outside the grid, parked
    pts[0] = c0 + [RADIUS + 0.1, 0.1, 0.1]
    pts[1] = c0 + [0.1, RADIUS + 0.05, 0.1]
    pts[2] = pos[np.argmax(np.abs(pos).sum(1))] + [0.1, 0.0, 0.0]
    pts[3] = [-500.0, 0.0, 0.0]
    pts[4] = [1e30, 1e30, 1e30]
    eye = rng.normal(size=(300, 3))
    eye /= np.linalg.norm(eye, axis=1, keepdims=True)
    irr, found = tph.irradiance_estimate(tpm, torch.from_numpy(pts),
                                         torch.from_numpy(eye), NUM, RADIUS,
                                         CONE_K)
    jirr, jfound = jph.irradiance_estimate(jpm, jnp.asarray(pts),
                                           jnp.asarray(eye), NUM, RADIUS,
                                           CONE_K)
    want, wfound = _oracle(pos, power, dirs, pts, eye, RADIUS, NUM, CONE_K)
    assert np.array_equal(found.numpy(), wfound)
    assert int(found[0]) == NUM and int(found[1]) > 0
    # a query parked at 1e30 meets the JAX map's dead packed lanes in its
    # `found` (ROADMAP C13); elsewhere the JAX counts are exact
    assert np.array_equal(found.numpy()[5:], np.asarray(jfound)[5:])
    np.testing.assert_allclose(irr.numpy(), np.asarray(jirr), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(irr.numpy(), want, rtol=1e-9, atol=1e-12)


def test_strays_leave_the_tables_the_size_of_the_photons():
    rng = np.random.default_rng(7)
    pos = rng.uniform(-1, 1, (600, 3))
    pos[:6] = [[30.0, 0, 0], [-30.0, 0, 0], [0, 30.0, 0], [0, -30.0, 0],
               [0, 0, 30.0], [0, 0, -30.0]]
    power = rng.uniform(0, 1, (600, 3))
    dirs = rng.normal(size=(600, 3))
    tpm = tph.build_photon_map(pos, power, dirs, RADIUS, F64, "cpu")
    dense = math.prod(tpm.dims)
    assert dense > 1000 * tpm.n
    occupied = tpm.cell_keys.numel()
    assert tpm.row_start.numel() == occupied + 1
    assert occupied + tpm.row_start.numel() <= tpm.n + occupied + 1
    assert torch.equal(tpm.cell_keys, torch.unique(tpm.cell_keys))
    pts = rng.uniform(-1.2, 1.2, (200, 3))
    pts[0] = [30.1, 0.0, 0.0]
    eye = rng.normal(size=(200, 3))
    irr, found = tph.irradiance_estimate(tpm, torch.from_numpy(pts),
                                         torch.from_numpy(eye), NUM, RADIUS,
                                         CONE_K)
    want, wfound = _oracle(pos, power, dirs, pts, eye, RADIUS, NUM, CONE_K)
    assert np.array_equal(found.numpy(), wfound) and int(found[0]) == 1
    np.testing.assert_allclose(irr.numpy(), want, rtol=1e-9, atol=1e-12)


def test_jax_maps_own_photons_rebuild_the_same_map():
    """The JAX map's photons, read back from its packed rows, give the
    port a map of the same grid and photon order."""
    pos, power, dirs, _ = _cloud(5)
    jpm = jph.build_photon_map(pos, power, dirs, RADIUS, jnp.float64)
    tpm = tph.build_photon_map(*jax_map_arrays(jpm), RADIUS, F64, "cpu")
    ref = tph.build_photon_map(pos, power, dirs, RADIUS, F64, "cpu")
    assert tpm.dims == ref.dims and tpm.max_neighbors == ref.max_neighbors
    assert torch.equal(tpm.cell_keys, ref.cell_keys)
    assert torch.equal(tpm.row_start, ref.row_start)


def test_cornell_gi_frame_matches_the_frozen_reference(tmp_path):
    from benchmark.reference.frt.render.render import (
        render_scene as ref_render)
    from benchmark.reference.frt.scene.yaml_loader import (
        load_scene as ref_load)
    # the box without its block, whose triangles take the plain path's
    # every ray against every triangle on the CPU
    tree = tdemo._cornell_tree(24, 24, None)
    for entry in tree:
        if entry.get("add") == "config":
            gi = entry["illumination"]["global-illumination"]
            gi.update({"photon-count": 2000, "usteps": 2, "vsteps": 2})
        if entry.get("add") == "camera":
            entry.update(usteps=2, vsteps=2)
        if entry.get("add") == "light":
            # 2x2 light samples: the estimate's inputs are the same kind,
            # for a 25th of the shadow rays
            entry.update(usteps=2, vsteps=2)
    path = tmp_path / "cornell.yml"
    path.write_text(json.dumps(tree))
    stats = {}
    got = trender.render_scene(tyaml.load_scene(str(path)), dtype=F64,
                               device="cpu", seed=11, stats=stats)
    want = ref_render(ref_load(str(path)), dtype=F64, device="cpu", seed=11)
    assert stats["photons"][tph.GLOBAL]["stored"] and got.any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
