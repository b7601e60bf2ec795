"""Photon-mapped global illumination: the photon pass, the photon map and
the render-time GI terms.

The reference traces photons one at a time through a recursive Russian-
roulette walk into Jensen kd-tree photon maps and answers render-time
irradiance queries with a recursive kd kNN search
(src/renderer/photon_tracer.c, src/libs/photon_map/pm.c). As in the JAX
package (fast_ray_tracer_tpu/render/photon.py):

  * photon tracing is a wavefront: a whole emission batch advances one
    bounce per step, each photon takes ONE Russian-roulette branch per
    bounce, and the batch's stores are appended on the device (a cumsum
    rank, writes past the light's target dropped) with one host sync per
    batch;
  * the kd-tree is a uniform grid over the stored photons (cell edge =
    the search radius), so a query reads the photons of its 27
    neighboring cells;
  * the estimate is pm_irradiance_estimate's (pm.c:91-156): the strict
    d^2 < max_dist^2 range test, `found` capped at `num`, r^2 = the
    num-th nearest d^2 when `num` photons lie in range and max_dist^2
    otherwise, the cone weight 1 - d / (k * max_dist), the normalization
    1 / ((1 - 2 / (3k)) pi r^2), at least 8 photons, photons from behind
    `eyev` rejected (the reference passes eyev as the normal — a quirk,
    kept). On the card it is one hand-written CUDA query kernel
    (csrc/photon.cu); the torch route is the CPU's, the gradient's and
    the kernel's reference.

Storage rules (photon_tracer.c:113-183): the caustic map stores only
after at least one specular bounce, the global map only after at least
one diffuse bounce (never the first diffuse hit); the stored power is
Kd * incident power; the RR thresholds are the channel means of the
diffuse, specular and transmission reflectances; a specular or refracted
continuation divides the power by its mean reflectance (a reference
quirk, not the standard RR normalization).

Every drawing function takes the numbers it consumes as arguments
(`emit_photons`, `photon_bounce_wave`, `final_gather`); the `draw_*`
functions draw them from an RNG node (sampling/rng.py) where the JAX
package draws from its key. The photon map's layout is the GPU's:
cell-sorted (N, 3) position, power and direction tensors with a CSR
`row_start` in photon units (the JAX package packs 14 photons per
128-float row for the TPU's gathers; the estimates are the same).

Gradients: the photon pass runs without autograd (the map's photons are
frozen); `live_photon_powers` replays each stored photon's provenance
against the live light and material tables, so a hook made with
`make_gi_hook(..., live_power=True)` carries pixel gradients into
light_intensity, mat_Kd, mat_refl and mat_Tf, and through the estimate's
cone weights into the query points.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from fast_ray_tracer_tpu_torch import _build
from fast_ray_tracer_tpu_torch import colors as colorlib
from fast_ray_tracer_tpu_torch.ops.gather import take_rows
from fast_ray_tracer_tpu_torch.ops.vec import dot3
from fast_ray_tracer_tpu_torch.render.integrator import (
    coordinate_frame, prepare_computations, refract_active,
    refract_direction,
)
from fast_ray_tracer_tpu_torch.sampling.rng import RNG
from fast_ray_tracer_tpu_torch.scene import ir as IR
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR
from fast_ray_tracer_tpu_torch.utils.profiling import (
    CounterGroup, count, host_sync, span,
)

CAUSTIC, GLOBAL = 0, 1

# provenance event codes of a stored photon's power chain (the live
# photon powers replay them): EV_KD multiplies by the hit's Kd, EV_SPEC
# divides by its mean reflectance, EV_TRANS by its mean Tf; + EV_MAPPED
# when the value came from a pattern sample, not the table
EV_NONE, EV_KD, EV_SPEC, EV_TRANS = 0, 1, 2, 3
EV_MAPPED = 4

# the photon pass's batch plan on the card: a light's first batch is the
# power of two at or above twice its target, which measures the scene's
# stores per emitted photon; each later batch is the power of two that
# covers the light's remaining deficit at that rate with 1.3x margin; all
# within [MIN, MAX]. One host sync per batch (the running store count). A
# light whose batches store nothing more than PHOTON_STALL_BATCHES times
# in a row stops short.
PHOTON_BATCH_MIN = 1 << 12
PHOTON_BATCH_MAX = 1 << 19
PHOTON_STALL_BATCHES = 16

# since the last reset (a plain int each): the CUDA query kernel's calls,
# and the CUDA estimates on the grad path that took the torch route; the
# tracer's counters launches.irradiance and launches.irradiance_plain
LAUNCHES = CounterGroup("launches.", "irradiance", "irradiance_plain")

# the torch route's candidate tables: the device bytes one block of
# queries may hold (the JAX package's `_query_block` budget)
QUERY_BUDGET_BYTES = 1 << 30
# bytes a candidate slot takes across a block's tables: its photon index
# and cell (int64), its gathered position, power and direction, d^2 and
# the weight and mask temporaries
_SLOT_INDEX_BYTES, _SLOT_FLOATS = 24, 16
# the narrowest candidate table; each width class doubles it
_MIN_WIDTH = 32


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

def cosine_hemisphere(r, normals):
    """cosine_weighted_sample_hemisphere (sampler.c:39-64) around per-ray
    normals (R, 3) from uniforms r (R, 2): (directions (R, 3), r1 (R,));
    final_gather scales by r1 (renderer.c:662)."""
    r1, r2 = r[:, 0], r[:, 1]
    rad = torch.sqrt(r2)
    theta = 2.0 * math.pi * r1
    sx = rad * torch.cos(theta)
    sz = rad * torch.sin(theta)
    sy = torch.sqrt((1.0 - r2).clamp(min=0.0))
    nt, nb = coordinate_frame(normals)
    d = sx[:, None] * nb + sy[:, None] * normals + sz[:, None] * nt
    d = d / torch.sqrt(dot3(d, d).clamp(min=1e-30))[:, None]
    return d, r1


def emit_photons(ir: SceneIR, li: int, u1, u2):
    """light->emit_photon for a batch (light.c:14-97): (origins, directions)
    from the light's draws — point: normals u1 (n, 3), a uniform sphere
    direction; area: uniforms u1 (n, 2) on the light's rectangle; circle:
    indices u1 (n,) into its S cached sample points; hemisphere: u1
    unused. Area, circle and hemisphere lights emit cosine-weighted
    around their normal from uniforms u2 (n, 2)."""
    typ, usteps, vsteps = ir.meta.light_info[li][:3]
    if typ == IR.LIGHT_POINT:
        d = u1 / torch.sqrt(dot3(u1, u1).clamp(min=1e-30))[:, None]
        return ir.light_pos[li][None].expand(u1.shape[0], 3), d
    n = u2.shape[0]
    if typ == IR.LIGHT_AREA:
        # the stored uvec/vvec are per step: the full edge is step * steps
        o = (ir.light_pos[li][None]
             + (u1[:, 0] * usteps)[:, None] * ir.light_uvec[li][None]
             + (u1[:, 1] * vsteps)[:, None] * ir.light_vvec[li][None])
        nvec = torch.linalg.cross(ir.light_uvec[li], ir.light_vvec[li])
        nvec = nvec / torch.sqrt(dot3(nvec, nvec).clamp(min=1e-30))
    elif typ in (IR.LIGHT_CIRCLE, IR.LIGHT_HEMISPHERE):
        if typ == IR.LIGHT_CIRCLE:
            o = ir.light_points[li][u1]
        else:
            o = ir.light_pos[li][None].expand(n, 3)
        nvec = ir.light_normal[li]
    else:
        raise ValueError(f"unsupported light type {typ}")
    d, _ = cosine_hemisphere(u2, nvec[None].expand(n, 3))
    return o, d


def draw_emission(ir: SceneIR, li: int, rng, n: int, dtype):
    """emit_photons' draws (u1, u2) for n photons of light li, split from
    `rng` as the JAX package splits its key."""
    typ = ir.meta.light_info[li][0]
    k1, k2 = rng.split(2)
    if typ == IR.LIGHT_POINT:
        return k1.normal((n, 3), dtype), None
    if typ == IR.LIGHT_AREA:
        u1 = k1.uniform((n, 2), dtype)
    elif typ == IR.LIGHT_CIRCLE:
        u1 = k1.randint((n,), 0, ir.meta.light_info[li][4])
    else:
        u1 = None
    return u1, k2.uniform((n, 2), dtype)


# ---------------------------------------------------------------------------
# the photon bounce wavefront
# ---------------------------------------------------------------------------

def _slot_mapped(ir: SceneIR, mat, slot):
    """(R,) bool: the lane's material samples a pattern for `slot` (None
    when no material of the scene patterns that slot)."""
    if slot not in ir.meta.pattern_slots:
        return None
    return ir.mat_map[mat, slot] >= 0


def tracks_samples(ir: SceneIR) -> bool:
    """Whether the provenance chains record pattern samples (some
    material patterns Kd or refl)."""
    return (IR.SLOT_KD in ir.meta.pattern_slots
            or IR.SLOT_REFL in ir.meta.pattern_slots)


class Bounces(NamedTuple):
    """photon_bounce_wave's output, levels stacked: leading dim L * n."""
    pos: torch.Tensor            # (L*n, 3) hit points
    power: torch.Tensor          # (L*n, 3) stored power (Kd * incident)
    dirs: torch.Tensor           # (L*n, 3) incident directions
    store: torch.Tensor          # (L*n,) bool
    chain_mat: torch.Tensor      # (L*n, L) int64 event materials
    chain_code: torch.Tensor     # (L*n, L) int64 EV_* codes
    chain_samp: Optional[torch.Tensor]   # (L*n, L, 3) pattern samples


def photon_bounce_wave(ir: SceneIR, rt, map_type: int, orig, dirs, power,
                       rr, hemi) -> Bounces:
    """Trace one photon batch through gi_path_length bounces
    (photon_tracer.c:113-183), from its draws: rr (L-1, n) the Russian-
    roulette uniform of each photon and bounce, hemi (L-1, n, 2) the
    uniforms of its diffuse direction.

    The chains are the provenance of each stored power: slot s < t holds
    the RR branch event of bounce s, slot t the store hit's Kd. Dead
    photons are parked at 1e30 (the compaction's fill row), which every
    intersector takes as a miss (ops/intersect._finite in float32)."""
    L = rt.cfg.gi_path_length
    n = orig.shape[0]
    dev = orig.device
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    had_d = torch.zeros(n, dtype=torch.bool, device=dev)
    had_s = torch.zeros(n, dtype=torch.bool, device=dev)
    track = tracks_samples(ir)
    ch_mat = torch.zeros((n, L), dtype=torch.int64, device=dev)
    ch_code = torch.zeros((n, L), dtype=torch.int64, device=dev)
    ch_samp = torch.zeros((n, L, 3), dtype=orig.dtype, device=dev) \
        if track else None
    outs = []
    for step in range(L):
        comps = prepare_computations(ir, rt, orig, dirs, shadow_filter=True)
        # dead photons, and photons that hit nothing, stop
        alive = alive & comps.valid & (power > 0.0).any(-1)
        kd = comps.over_Kd
        stored_power = kd * power
        diffuse_ok = (kd > 0.0).any(-1)
        store = alive & diffuse_ok & (had_s if map_type == CAUSTIC
                                      else had_d)
        kd_mapped = _slot_mapped(ir, comps.mat, IR.SLOT_KD)
        store_code = torch.full_like(comps.mat, EV_KD) if kd_mapped is None \
            else torch.where(kd_mapped, EV_KD + EV_MAPPED, EV_KD)
        out_mat, out_code = ch_mat.clone(), ch_code.clone()
        out_mat[:, step] = comps.mat
        out_code[:, step] = store_code
        out_samp = None
        if track:
            out_samp = ch_samp.clone()
            out_samp[:, step] = kd
        outs.append((comps.p, stored_power, dirs, store, out_mat, out_code,
                     out_samp))
        if step == L - 1:
            break

        # russian roulette (photon_tracer.c:157-181): one uniform picks the
        # branch; the caustic pass never bounces diffusely
        avg_d = kd.mean(-1)
        avg_s = comps.over_refl.mean(-1)
        avg_t = comps.tf.mean(-1)
        if map_type == CAUSTIC:
            avg_d = torch.zeros_like(avg_d)
        total = avg_d + avg_s + avg_t
        x = rr[step] * total
        go_d = x < avg_d
        go_s = ~go_d & (x < avg_d + avg_s)
        go_t = ~go_d & ~go_s & (x < total)
        # branch validity (reflect_photon_specular / refract_photon guards)
        go_s = go_s & comps.refl_flag
        go_t = go_t & (comps.tr.abs() >= 1e-5) & refract_active(comps)

        d_diff, _ = cosine_hemisphere(hemi[step], comps.normalv)
        new_dir = torch.where(go_d[:, None], d_diff,
                              torch.where(go_s[:, None], comps.reflectv,
                                          refract_direction(comps)))
        new_orig = torch.where(go_t[:, None], comps.under_point,
                               comps.over_point)

        def safe(a):
            return torch.where(a > 0, a, 1.0)[:, None]
        new_power = torch.where(
            go_d[:, None], stored_power,
            torch.where(go_s[:, None], power / safe(avg_s),
                        power / safe(avg_t)))
        # the branch event, in the running chain
        refl_mapped = _slot_mapped(ir, comps.mat, IR.SLOT_REFL)
        code_s = torch.full_like(comps.mat, EV_SPEC) if refl_mapped is None \
            else torch.where(refl_mapped, EV_SPEC + EV_MAPPED, EV_SPEC)
        ch_mat[:, step] = comps.mat
        ch_code[:, step] = torch.where(
            go_d, store_code, torch.where(
                go_s, code_s, torch.where(go_t, EV_TRANS, EV_NONE)))
        if track:
            ch_samp[:, step] = torch.where(
                go_d[:, None], kd,
                torch.where(go_s[:, None], comps.over_refl, 0.0))
        had_d = had_d | (alive & go_d)
        had_s = had_s | (alive & (go_s | go_t))
        alive = alive & (go_d | go_s | go_t)
        power = new_power
        # park dead photons outside the scene
        orig = torch.where(alive[:, None], new_orig, 1e30)
        dirs = torch.where(alive[:, None], new_dir, 1.0)

    cat = [torch.cat([o[i] for o in outs]) for i in range(6)]
    return Bounces(*cat, chain_samp=torch.cat([o[6] for o in outs])
                   if track else None)


def draw_bounces(rng, n: int, L: int, dtype):
    """photon_bounce_wave's draws (rr, hemi) for n photons: bounce s folds
    s into `rng`, then 1 for the RR uniform and 2 for the direction."""
    dev = rng.device
    if L < 2:
        return (torch.zeros((0, n), dtype=dtype, device=dev),
                torch.zeros((0, n, 2), dtype=dtype, device=dev))
    ks = [rng.fold(s) for s in range(L - 1)]
    return (torch.stack([k.fold(1).uniform((n,), dtype) for k in ks]),
            torch.stack([k.fold(2).uniform((n, 2), dtype) for k in ks]))


# ---------------------------------------------------------------------------
# the photon map
# ---------------------------------------------------------------------------

class PhotonMap(NamedTuple):
    """Stored photons sorted by grid cell, on the device, and the grid's
    occupied cells.

    Cell (i, j, k) of `dims` has edge `cell_size` (the search radius) from
    `grid_origin`; its id is (i * dims[1] + j) * dims[2] + k. Only the
    cells that hold a photon have rows in the tables, so the tables grow
    with the photons and not with the box that bounds them (photons that
    leave the scene land far out on its infinite planes): `cell_keys`
    holds their ids in ascending order, and the photons of the m-th are
    rows row_start[m] .. row_start[m + 1] of pos, power and dirs. The
    prov_* tensors (same order) are each photon's provenance: the
    emitting light and the chains of photon_bounce_wave, which
    live_photon_powers replays."""
    pos: torch.Tensor            # (N, 3)
    power: torch.Tensor          # (N, 3), already / photon_count
    dirs: torch.Tensor           # (N, 3) incident directions
    cell_keys: torch.Tensor      # (M,) int64 occupied cell ids, ascending
    row_start: torch.Tensor      # (M + 1,) int64 CSR offsets
    grid_origin: tuple
    cell_size: float
    dims: tuple
    n: int
    max_neighbors: int           # the most photons of any 27-cell block
    prov_light: Optional[torch.Tensor] = None   # (N,) int64
    prov_mat: Optional[torch.Tensor] = None     # (N, L) int64
    prov_code: Optional[torch.Tensor] = None    # (N, L) int64
    prov_samp: Optional[torch.Tensor] = None    # (N, L, 3)
    power_div: float = 1.0                      # photon_count

    def to(self, device) -> "PhotonMap":
        """The map with every tensor on `device`."""
        return self._replace(**{
            k: v.to(device) for k, v in self._asdict().items()
            if isinstance(v, torch.Tensor)})


_OFFSETS = [(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
            for oz in (-1, 0, 1)]


def _neighbor_ids(cell, dims):
    """The ids of the 27 cells around each cell (R, 3) int64 of a grid of
    `dims` (a (3,) int64 tensor), (R, 27), and whether each lies in the
    grid; an id outside it is meaningless."""
    with host_sync("upload"):
        offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=cell.device)
    inb = None
    for a in range(3):
        c = cell[:, a:a + 1] + offs[:, a]
        ok = (c >= 0) & (c < dims[a])
        inb = ok if inb is None else inb & ok
    d1, d2 = dims[1], dims[2]
    own = (cell[:, 0] * d1 + cell[:, 1]) * d2 + cell[:, 2]
    step = (offs[:, 0] * d1 + offs[:, 1]) * d2 + offs[:, 2]
    return own[:, None] + step, inb


def _neighborhood_max(keys, counts, dims):
    """The most photons in any in-grid cell's 3x3x3 block, a device
    scalar. Only a cell next to an occupied one has a block that holds a
    photon, so each occupied cell's count goes to the 27 cells around it
    (nothing to those outside the grid), and the sums are taken by cell
    over the sorted ids: no table of the grid's size, no host sync."""
    d1, d2 = dims[1], dims[2]
    cell = torch.stack([keys // (d1 * d2), keys // d2 % d1, keys % d2], -1)
    ids, inb = _neighbor_ids(cell, dims)
    ids, order = torch.sort(ids.reshape(-1))
    val = torch.where(inb, counts[:, None], 0).reshape(-1)[order]
    run = torch.cumsum(val, 0)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    # the running sum at each cell's first entry, carried over its entries
    # (the running sum never falls)
    before = torch.where(first, run - val, 0).cummax(0).values
    return (run - before).max()


def build_photon_map(pos, power, dirs, radius: float, dtype, device,
                     prov: Optional[dict] = None,
                     power_div: float = 1.0) -> Optional[PhotonMap]:
    """The grid over N stored photons, built on `device`: cell edge = the
    search radius, so a query touches exactly its 27 neighboring cells;
    photons sorted by cell id, stably; tables for the occupied cells
    only. `pos`, `power`, `dirs` ((N, 3) each) and `prov`'s entries may be
    arrays or tensors; `power` is stored as given. Two host syncs (both
    `photon_grid`): the count of occupied cells, then the grid's origin,
    dims and max_neighbors. None when no photon was stored."""
    def dev(a, dt=dtype):
        t = a if torch.is_tensor(a) else torch.tensor(a)
        return t.to(device=device, dtype=dt)
    pos = dev(pos)
    n = pos.shape[0]
    if n == 0:
        return None
    # a divisor on the device: CUDA divides by a host scalar through its
    # reciprocal, which can move a photon across a cell face
    r = torch.full((), radius, dtype=pos.dtype, device=pos.device)
    origin = pos.amin(0) - 1e-6
    extent = pos.amax(0) - origin + 1e-6
    dims = (torch.ceil(extent / r).to(torch.int64) + 1).clamp(min=1)
    cell = torch.minimum(torch.floor((pos - origin) / r).to(torch.int64),
                         dims - 1)
    cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    cid, order = torch.sort(cid, stable=True)
    with host_sync("photon_grid"):
        keys, counts = torch.unique_consecutive(cid, return_counts=True)
    count("photon.grid_cells", keys.shape[0])
    row_start = torch.zeros(keys.shape[0] + 1, dtype=torch.int64,
                            device=pos.device)
    torch.cumsum(counts, 0, out=row_start[1:])
    most = _neighborhood_max(keys, counts, dims)
    with host_sync("photon_grid"):
        meta = torch.cat([origin.double(), dims.double(),
                          most.double()[None]]).tolist()

    def rows(a, dt=dtype):
        return dev(a, dt)[order]
    extra = {}
    if prov is not None:
        extra = dict(prov_light=rows(prov["light"], torch.int64),
                     prov_mat=rows(prov["mat"], torch.int64),
                     prov_code=rows(prov["code"], torch.int64),
                     prov_samp=None if prov.get("samp") is None
                     else rows(prov["samp"]), power_div=float(power_div))
    return PhotonMap(
        pos=pos[order], power=rows(power), dirs=rows(dirs), cell_keys=keys,
        row_start=row_start, grid_origin=tuple(meta[:3]),
        cell_size=float(radius), dims=tuple(int(d) for d in meta[3:6]), n=n,
        max_neighbors=int(meta[6]), **extra)


# ---------------------------------------------------------------------------
# the photon pass
# ---------------------------------------------------------------------------

def photon_targets(ir: SceneIR, photon_count: int):
    """Each light's share of photon_count, apportioned by the CIE-Lab
    lightness of its intensity (photon_tracer.c:202-257), in float64."""
    with host_sync("photon_targets"):
        inten = ir.light_intensity.detach().to("cpu", torch.float64).numpy()
    L_vals = [float(colorlib.rgb_to_lab(inten[li])[0])
              for li in range(ir.meta.n_lights)]
    total = sum(L_vals) or 1.0
    return [int(photon_count * lv / total) for lv in L_vals]


def _append(bufs, vals, store, count, limit):
    """Append this batch's stores at rows count.. of the buffers, in order,
    dropping those at or past `limit` into the buffers' last (sink) row;
    the new count, min(count + stores, limit), stays on the device."""
    rank = torch.cumsum(store.to(torch.int64), 0) - 1
    dst = count + rank
    ok = store & (dst < limit)
    dst = torch.where(ok, dst, bufs[0].shape[0] - 1)
    for b, v in zip(bufs, vals):
        b.index_copy_(0, dst, v.to(b.dtype))
    return torch.clamp(count + store.sum(), max=limit)


def _batch_size(need: float) -> int:
    """The power of two at or above `need`, within the batch plan's
    [PHOTON_BATCH_MIN, PHOTON_BATCH_MAX]."""
    return min(PHOTON_BATCH_MAX, max(PHOTON_BATCH_MIN, 1 << max(
        0, math.ceil(math.log2(max(need, 1.0))))))


def _trace_map(ir: SceneIR, rt, rng, dtype, map_type: int, targets,
               batch: Optional[int], track: bool):
    """One map's emission and bounce waves, each light until its target is
    stored or it stalls: (stores, the device buffers, the map's stats).
    The buffers' rows .. stores are the stored photons: position, power,
    direction, the chains' materials and codes, the light, and the
    chains' samples when `track`."""
    L = rt.cfg.gi_path_length
    dev = ir.light_pos.device
    rows = sum(targets) + 1                       # + the sink row
    bufs = [torch.zeros((rows, 3), dtype=dtype, device=dev)
            for _ in range(3)]
    bufs += [torch.zeros((rows, L), dtype=torch.int64, device=dev)
             for _ in range(2)]
    bufs.append(torch.zeros(rows, dtype=torch.int64, device=dev))
    if track:
        bufs.append(torch.zeros((rows, L, 3), dtype=dtype, device=dev))
    count_t = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    mstats = {"targets": list(targets), "stored": [], "batches": 0,
              "syncs": 0, "emitted": 0, "stalled": []}
    for li in range(ir.meta.n_lights):
        with host_sync("photon_count"):
            base = got = int(count_t)
        limit = base + targets[li]
        stalls = emitted = 0
        b = batch or _batch_size(2 * targets[li])
        while got < limit:
            k = rng.fold(7919 * map_type + 31 * li + it)
            it += 1
            o, d = emit_photons(ir, li, *draw_emission(ir, li, k, b, dtype))
            power = ir.light_intensity[li][None].expand(b, 3).to(dtype)
            bw = photon_bounce_wave(ir, rt, map_type, o, d, power,
                                    *draw_bounces(k.fold(1), b, L, dtype))
            vals = [bw.pos, bw.power, bw.dirs, bw.chain_mat, bw.chain_code,
                    torch.full((b * L,), li, dtype=torch.int64, device=dev)]
            if track:
                vals.append(bw.chain_samp)
            count_t = _append(bufs, vals, bw.store, count_t, limit)
            emitted += b
            with host_sync("photon_count"):   # the batch's one sync
                new_got = int(count_t)
            mstats["batches"] += 1
            mstats["syncs"] += 1
            stalls = stalls + 1 if new_got == got else 0
            got = new_got
            if stalls > PHOTON_STALL_BATCHES:
                mstats["stalled"].append(
                    f"light {li}: {PHOTON_STALL_BATCHES + 1} batches in "
                    f"a row stored nothing ({got - base} of "
                    f"{targets[li]} stored)")
                break
            if batch is None and got < limit:
                rate = (got - base) / emitted
                b = _batch_size((limit - got) / rate * 1.3 if rate > 0
                                else PHOTON_BATCH_MAX)
        mstats["stored"].append(got - base)
        mstats["emitted"] += emitted
    with host_sync("photon_count"):
        n_stored = int(count_t)
    mstats["syncs"] += 1
    return n_stored, bufs, mstats


@torch.no_grad()
def trace_photons(ir: SceneIR, rt, rng, dtype, caustic: bool, global_: bool,
                  batch: Optional[int] = None, stats: Optional[dict] = None):
    """trace_photons (photon_tracer.c:202-257): {CAUSTIC: map, GLOBAL: map}
    (None where disabled or empty). Each light is traced until its own
    share (`photon_targets`) is stored, like the reference's per-light
    loop — a light that stalls leaves its deficit unfilled; stored powers
    are scaled by 1 / photon_count. Emission, the bounce wavefront, the
    append and the map build run on the device, one host sync per batch
    and two per map build (build_photon_map). `batch` fixes the batch size
    (the tests' small batches); else the card's plan of PHOTON_BATCH_MIN /
    MAX. Batch b of light li in map m draws from
    rng.fold(7919 m + 31 li + b), its bounces from that node's fold(1).
    If `stats` is a dict it receives, per map, the targets, the stores per
    light, the batches and host syncs, and why a light stopped short.
    Traced per map as the spans "photon.trace" (emission and bounces) and
    "photon.build_map", with the counters photons.emitted, photons.stored
    and photon.grid_cells (the occupied cells).

    Runs under torch.no_grad(): the photon structure (positions,
    directions, store decisions, RR draws) is frozen at its traced values,
    as the JAX package's host-built map is; gradients reach the stored
    powers through `live_photon_powers`."""
    cfg = rt.cfg
    num = cfg.photon_count
    dev = ir.light_pos.device
    targets = photon_targets(ir, num)
    track = tracks_samples(ir)
    maps = {}
    for map_type, enabled in ((CAUSTIC, caustic), (GLOBAL, global_)):
        maps[map_type] = None
        if not enabled:
            continue
        if map_type == CAUSTIC and not (ir.meta.has_reflective
                                        or ir.meta.has_refractive):
            # a scene with no specular material can never store a caustic
            # photon (photon_tracer.c:139-143): skip the stall loop
            continue
        with span("photon.trace", map=map_type):
            n_stored, bufs, mstats = _trace_map(ir, rt, rng, dtype, map_type,
                                                targets, batch, track)
        count("photons.emitted", mstats["emitted"])
        count("photons.stored", n_stored)
        if stats is not None:
            stats[map_type] = mstats
        if not n_stored:
            continue
        with span("photon.build_map", map=map_type):
            got = [x[:n_stored] for x in bufs]
            # a true division by a device tensor, as live_photon_powers
            # divides
            div = torch.full((), float(num), dtype=dtype, device=dev)
            prov = {"light": got[5], "mat": got[3], "code": got[4],
                    "samp": got[6] if track else None}
            maps[map_type] = build_photon_map(
                got[0], got[1] / div, got[2],
                cfg.irradiance_estimate_radius, dtype, dev, prov=prov,
                power_div=float(num))
    return maps


def live_photon_powers(pm: PhotonMap, ir: SceneIR):
    """Each stored photon's power (N, 3) replayed from its provenance
    against the live light and material tables, differentiable in
    light_intensity, mat_Kd, mat_refl and mat_Tf (the JAX package's
    live_photon_powers).

    The chain starts at the emitting light's intensity; an EV_KD event
    multiplies by the hit's Kd, EV_SPEC divides by its mean reflectance,
    EV_TRANS by its mean Tf (each through photon_bounce_wave's safe
    divisor), and an EV_MAPPED event takes the recorded pattern sample,
    which carries no gradient to the table (the pattern replaces the table
    value). Every operation is the bounce wave's, in its order, and the
    end divides by power_div as the map build does, so at the traced
    values the result is the stored `power` bit for bit."""
    L = pm.prov_mat.shape[1]
    pw = take_rows(ir.light_intensity, pm.prov_light)

    def safe(a):
        return torch.where(a > 0, a, 1.0)[:, None]
    for step in range(L):
        mat = pm.prov_mat[:, step]
        code = pm.prov_code[:, step]
        base = (code % EV_MAPPED)[:, None]
        kd, refl = take_rows(ir.mat_Kd, mat), take_rows(ir.mat_refl, mat)
        if pm.prov_samp is not None:
            mapped = (code >= EV_MAPPED)[:, None]
            samp = pm.prov_samp[:, step]
            kd = torch.where(mapped, samp, kd)
            refl = torch.where(mapped, samp, refl)
        pw = torch.where(
            base == EV_KD, kd * pw, torch.where(
                base == EV_SPEC, pw / safe(refl.mean(-1)), torch.where(
                    base == EV_TRANS,
                    pw / safe(take_rows(ir.mat_Tf, mat).mean(-1)),
                    pw)))
    # a true division by a device tensor: a CUDA division by a host scalar
    # multiplies by its reciprocal, which would move the last bit
    return pw / torch.full((1, 1), pm.power_div, dtype=pw.dtype,
                           device=pw.device)


def with_live_power(pm: Optional[PhotonMap], ir: SceneIR):
    """The map with `power` a live function of `ir` (live_photon_powers);
    positions, directions and the grid keep their traced values. `pm`
    itself when it is None or carries no provenance."""
    if pm is None or pm.prov_mat is None:
        return pm
    return pm._replace(power=live_photon_powers(pm, ir))


# ---------------------------------------------------------------------------
# the irradiance estimate
# ---------------------------------------------------------------------------

def _neighbor_extents(pm: PhotonMap, points):
    """Per query the photon-row extents of its 27 neighbor cells: (starts,
    ends), each (R, 27), as a dense CSR over every cell of the grid would
    give them (a cell's start is the count of photons in the cells of
    lower id); empty and out-of-grid cells are empty, an out-of-grid
    cell's start is 0. Each cell is looked up among the occupied ones."""
    dev, dtype = points.device, points.dtype
    with host_sync("upload", 3):
        org = torch.tensor(pm.grid_origin, dtype=dtype, device=dev)
        hi = torch.tensor([d - 1 for d in pm.dims], dtype=dtype, device=dev)
        dims = torch.tensor(pm.dims, device=dev)
    # clamp before the integer conversion: parked points (1e30) overflow it
    cell = torch.minimum(torch.floor((points - org) / pm.cell_size)
                         .clamp(min=0.0), hi).to(torch.int64)
    cidx, inb = _neighbor_ids(cell, dims)
    del cell
    m = pm.cell_keys.shape[0]
    at = torch.searchsorted(pm.cell_keys, cidx)
    hit = inb & (pm.cell_keys[at.clamp(max=m - 1)] == cidx)
    del cidx
    s = torch.where(inb, pm.row_start[at], 0)
    e = torch.where(hit, pm.row_start[(at + 1).clamp(max=m)], s)
    return s, e


def _estimate_block(pm: PhotonMap, points, eyev, s, e, width: int, num: int,
                    max_dist: float, cone_k: float):
    """The estimate for a block of queries whose candidates (the photons of
    their 27 neighbor cells) number at most `width` each: (irr, found, r2).

    The candidates go into a (Rb, width) table, slot j of a query holding
    the photon at offset j of the concatenation of its cells' extents. The
    num-th nearest d^2 comes from torch.kthvalue over the table: a
    selection on the card, exact, where the JAX package bisects on counts
    (the TPU sorts slowly; the two agree within an ulp of r^2). r^2 is a
    selection, so it carries no gradient, as the bisection's does not:
    the query points' gradient flows through the cone weights alone."""
    Rb = points.shape[0]
    dev = points.device
    md2 = max_dist * max_dist
    lens = e - s
    cum = torch.cumsum(lens, 1)                      # (Rb, 27)
    total = cum[:, -1]
    jj = torch.arange(width, device=dev).expand(Rb, width).contiguous()
    cj = torch.searchsorted(cum, jj, right=True).clamp(max=26)
    ok = jj < total[:, None]
    ridx = s.gather(1, cj) + jj - (cum - lens).gather(1, cj)
    ridx = torch.where(ok, ridx, 0)
    del cj, jj
    p = pm.pos[ridx]                                 # (Rb, width, 3)
    d2 = ((p[..., 0] - points[:, None, 0]) ** 2
          + (p[..., 1] - points[:, None, 1]) ** 2
          + (p[..., 2] - points[:, None, 2]) ** 2)
    del p
    d2 = torch.where(ok & (d2 < md2), d2, torch.inf)
    n_in = torch.isfinite(d2).sum(-1)
    # the reference's `found` is its heap population, capped at num
    found = n_in.clamp(max=num)
    r2 = torch.full((Rb,), md2, dtype=points.dtype, device=dev)
    if width >= num:
        kth = torch.kthvalue(d2.detach(), num, dim=-1).values
        r2 = torch.where(n_in >= num, kth, r2)
    sel = d2 <= r2[:, None]                          # inf never selected
    dr = pm.dirs[ridx]
    front = (dr[..., 0] * eyev[:, None, 0] + dr[..., 1] * eyev[:, None, 1]
             + dr[..., 2] * eyev[:, None, 2]) < 0.0
    del dr
    w = 1.0 - torch.sqrt(torch.where(sel, d2, 1.0).clamp(min=0.0)) \
        * (1.0 / (cone_k * max_dist))
    wm = torch.where(sel & front, w, 0.0)
    # index_select, not pm.power[ridx]: under live photon powers the
    # backward scatters each slot's cotangent into its photon's row; an
    # indexing gather's backward sorts every slot's index on the card (an
    # 800x800 Cornell chunk spent 97% of its device time there),
    # index_select's adds them atomically
    pw = pm.power.index_select(0, ridx.reshape(-1)).view(Rb, width, 3)
    irr = torch.stack([(wm * pw[..., i]).sum(-1) for i in range(3)], -1)
    norm = 1.0 / ((1.0 - 2.0 / (3.0 * cone_k)) * math.pi * r2)
    irr = irr * norm[:, None]
    return torch.where((found >= 8)[:, None], irr, 0.0), found, r2


def estimate_route(device_type: str, grad: bool) -> str:
    """Which implementation answers an estimate: "cpu" (the torch route,
    uncounted) for CPU tensors; on CUDA "irradiance" (the query kernel)
    unless `grad` (autograd on and the query points or the map's powers
    requiring grad), then "irradiance_plain" (the torch route, whose
    backward needs the per-slot cone weights that only its table holds)."""
    if device_type == "cpu":
        return "cpu"
    if device_type != "cuda":
        raise ValueError(f"no irradiance estimate for tensors on "
                         f"{device_type}")
    return "irradiance_plain" if grad else "irradiance"


def irradiance_estimate(pm: PhotonMap, points, eyev, num: int,
                        max_dist: float, cone_k: float):
    """pm_irradiance_estimate (pm.c:91-156) for a batch of queries:
    (irr (R, 3), found (R,) int64).

    On CUDA tensors off the grad path (estimate_route) the query kernel of
    csrc/photon.cu answers: one launch, no host sync, no upload. Else the
    torch route, `_irradiance_estimate`, which is the kernel's reference.
    Traced as the span "irradiance_estimate", with the counters
    gi.estimate_queries (R) and, on the torch route only,
    gi.estimate_slots (its candidate-table slots, from its class sizes;
    the kernel has no table); the kernel's calls and the CUDA grad-path
    calls count in LAUNCHES."""
    count("gi.estimate_queries", points.shape[0])
    with span("irradiance_estimate"):
        route = estimate_route(points.device.type, torch.is_grad_enabled()
                               and (points.requires_grad
                                    or pm.power.requires_grad))
        if route == "irradiance":
            return irradiance_cuda(pm, points, eyev, num, max_dist, cone_k)
        if route == "irradiance_plain":
            LAUNCHES.add("irradiance_plain")
        return _irradiance_estimate(pm, points, eyev, num, max_dist, cone_k)


_lib = None
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("photon")
        vp, i64, i32, f64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_double)
        for name in ("frt_irradiance_f32", "frt_irradiance_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, i64, vp, vp, vp, i64, vp, vp, i64, i64,
                           i64, i64, f64, f64, f64, f64, i32, f64, f64, f64,
                           vp, vp, vp, i32, vp]
            fn.restype = i32
        lib.frt_irradiance_light_max.argtypes = []
        lib.frt_irradiance_light_max.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def irradiance_cuda(pm: PhotonMap, points, eyev, num: int, max_dist: float,
                    cone_k: float, r2_out=None):
    """The estimate through the query kernel (csrc/photon.cu): one launch
    on the current stream; allocates the outputs alone. The scalars go to
    the kernel as Python computes them in the torch route. With `r2_out`
    (an (R,) tensor of the points' type and device) the kernel also writes
    each query's r^2 there, for the checks against the torch route."""
    dtype, dev = points.dtype, points.device
    if dtype not in _SUFFIX:
        raise TypeError(f"irradiance: float32 or float64, got {dtype}")
    for name, t in (("eyev", eyev), ("pos", pm.pos), ("power", pm.power),
                    ("dirs", pm.dirs)):
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"irradiance: {name} is {t.dtype} on "
                             f"{t.device}, the points {dtype} on {dev}")
    if num < 1 or pm.n >= 2 ** 31:
        raise ValueError(f"irradiance: num {num} below 1 or a map of "
                         f"{pm.n} photons")
    R = points.shape[0]
    if r2_out is not None and not (
            r2_out.shape == (R,) and r2_out.dtype == dtype
            and r2_out.device == dev and r2_out.is_contiguous()):
        raise ValueError("irradiance: r2_out must be a contiguous (R,) "
                         "tensor of the points' type and device")
    irr = torch.empty((R, 3), dtype=dtype, device=dev)
    found = torch.empty(R, dtype=torch.int64, device=dev)
    if R == 0:
        return irr, found
    pts = points.detach().contiguous()
    eye = eyev.detach().contiguous()
    pos, power, dirs = (t.detach().contiguous()
                        for t in (pm.pos, pm.power, pm.dirs))
    keys, rows = pm.cell_keys.contiguous(), pm.row_start.contiguous()
    err = getattr(_load(), f"frt_irradiance_{_SUFFIX[dtype]}")(
        pts.data_ptr(), eye.data_ptr(), R, pos.data_ptr(), power.data_ptr(),
        dirs.data_ptr(), pm.n, keys.data_ptr(), rows.data_ptr(),
        keys.shape[0], *pm.dims, *pm.grid_origin, pm.cell_size, num,
        max_dist * max_dist, 1.0 / (cone_k * max_dist),
        (1.0 - 2.0 / (3.0 * cone_k)) * math.pi, irr.data_ptr(),
        found.data_ptr(), 0 if r2_out is None else r2_out.data_ptr(),
        dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    LAUNCHES.add("irradiance")
    if err != 0:
        raise RuntimeError(f"irradiance: CUDA error {err} at launch")
    return irr, found


def _irradiance_estimate(pm, points, eyev, num, max_dist, cone_k,
                         r2_out=None):
    """The torch route. Queries are grouped by their candidate count into
    width classes (powers of two from _MIN_WIDTH up; a query with no
    candidate costs nothing) and processed in blocks whose candidate
    tables stay within QUERY_BUDGET_BYTES, so peak memory is bounded
    whatever R and however dense the map. Host syncs: three for the class
    sizes, one per class, and the grid's three small uploads. With
    `r2_out` (an (R,) tensor of the points' type) each query's r^2 goes
    there too, for the checks of the kernel."""
    R = points.shape[0]
    dev, dtype = points.device, points.dtype
    irr = torch.zeros((R, 3), dtype=dtype, device=dev)
    found = torch.zeros(R, dtype=torch.int64, device=dev)
    if r2_out is not None:
        r2_out.fill_(max_dist * max_dist)
    if R == 0:
        return irr, found
    s, e = _neighbor_extents(pm, points)
    total = (e - s).sum(1)
    n_classes = max(1, math.ceil(math.log2(max(pm.max_neighbors,
                                               _MIN_WIDTH) / _MIN_WIDTH)) + 1)
    cls = torch.ceil(torch.log2(total.clamp(min=_MIN_WIDTH).to(torch.float64)
                                / _MIN_WIDTH)).to(torch.int64)
    cls = torch.where(total > 0, cls.clamp(max=n_classes - 1), n_classes)
    # three waits on the card: bincount's bounds of `cls`, then the sizes
    with host_sync("estimate_classes", 3):
        sizes = torch.bincount(cls, minlength=n_classes + 1).tolist()
    slot_bytes = _SLOT_INDEX_BYTES + _SLOT_FLOATS * points.element_size()
    for c in range(n_classes):
        if not sizes[c]:
            continue
        width = min(_MIN_WIDTH << c, max(pm.max_neighbors, 1))
        count("gi.estimate_slots", sizes[c] * width)
        with host_sync("estimate_classes"):
            idx = torch.nonzero(cls == c)[:, 0]
        block = max(1, QUERY_BUDGET_BYTES // (width * slot_bytes))
        for lo in range(0, idx.shape[0], block):
            q = idx[lo:lo + block]
            bi, bf, br = _estimate_block(pm, points[q], eyev[q], s[q], e[q],
                                         width, num, max_dist, cone_k)
            irr.index_copy_(0, q, bi)
            found.index_copy_(0, q, bf)
            if r2_out is not None:
                r2_out.index_copy_(0, q, br.detach())
    return irr, found


# ---------------------------------------------------------------------------
# render-time GI terms
# ---------------------------------------------------------------------------

def lighting_gi(ir: SceneIR, rt, pm: PhotonMap, comps, cfg):
    """renderer.c:862-892: the global map's estimate scaled by 10 num /
    found; in visualize mode that raw estimate (renderer.c:880), else
    Kd * estimate * (eyev . normal)."""
    num = cfg.irradiance_estimate_num
    est, found = irradiance_estimate(
        pm, comps.over_point, comps.eyev, num,
        cfg.irradiance_estimate_radius, cfg.irradiance_estimate_cone_filter_k)
    scale = torch.where(found > 0, 10.0 * num
                        / found.clamp(min=1).to(est.dtype), 0.0)
    est = est * scale[:, None]
    if cfg.visualize_photon_map:
        return est
    return comps.over_Kd * est * dot3(comps.eyev, comps.normalv)[:, None]


def lighting_caustics(ir: SceneIR, rt, pm: PhotonMap, comps, cfg):
    """renderer.c:829-860: the caustic map's cone-filtered estimate * 100 /
    found, Kd * estimate * (eyev . normal) where Kd > 0. Traced as the
    span "gi.caustics"."""
    with span("gi.caustics"):
        return _lighting_caustics(pm, comps, cfg)


def _lighting_caustics(pm, comps, cfg):
    est, found = irradiance_estimate(
        pm, comps.over_point, comps.eyev, cfg.irradiance_estimate_num,
        cfg.irradiance_estimate_radius, cfg.irradiance_estimate_cone_filter_k)
    scale = torch.where(found > 0, 100.0 / found.clamp(min=1).to(est.dtype),
                        0.0)
    est = est * scale[:, None]
    caustic = comps.over_Kd * est * dot3(comps.eyev, comps.normalv)[:, None]
    return torch.where((comps.over_Kd > 0.0).any(-1)[:, None], caustic, 0.0)


def color_at_gi(ir: SceneIR, rt, pm_global: PhotonMap, orig, dirs, cfg):
    """renderer.c:319-345,626-653: one gather ray's radiance, pi *
    lighting_gi at its hit (no recursion)."""
    comps = prepare_computations(ir, rt, orig, dirs)
    c = math.pi * lighting_gi(ir, rt, pm_global, comps, cfg)
    gate = comps.valid & (comps.over_Kd > 0.0).any(-1)
    return torch.where(gate[:, None], c, 0.0)


def final_gather(ir: SceneIR, rt, pm_global: PhotonMap, comps, u, cfg):
    """renderer.c:647-687: gi_usteps x gi_vsteps cosine-weighted rays per
    shading point from uniforms u (S, R, 2), each scaled by its first
    uniform (the reference's "scale by theta" quirk), averaged with
    pdf_inv = 2 pi, times Kd. The S R rays go through one intersection
    and estimate pass, sample-major (sub-batch s holds sample s of every
    point). Traced as the span "gi.final_gather", with the counter
    gi.gather_rays (S R)."""
    S, R = u.shape[0], u.shape[1]
    count("gi.gather_rays", S * R)
    normals = comps.normalv[None].expand(S, R, 3).reshape(-1, 3)
    d, r1 = cosine_hemisphere(u.reshape(-1, 2), normals)
    orig = comps.over_point[None].expand(S, R, 3).reshape(-1, 3)
    with span("gi.final_gather"):
        c = color_at_gi(ir, rt, pm_global, orig, d, cfg)
    total = (c * r1[:, None]).reshape(S, R, 3).sum(0)
    return total * (2.0 * math.pi / S) * comps.over_Kd


def draw_gather(rng, S: int, R: int, dtype):
    """final_gather's uniforms (S, R, 2): sample s from rng.fold(s)."""
    return torch.stack([rng.fold(s).uniform((R, 2), dtype)
                        for s in range(S)])


def make_gi_hook(maps, cfg, live_power: bool = False):
    """The RenderStatics.gi_hook that shade_direct calls: the GI addition
    to the ambient channel per shading point (shade_direct clamps it).
    `maps` is trace_photons' dict.

    With `live_power` the maps' stored powers are a live function of the
    scene's tables (with_live_power), so pixel gradients reach mat_Kd,
    mat_refl, mat_Tf and light_intensity through the photon map; forward
    rendering keeps the stored constants. Such a hook carries `bind(ir)`:
    the same hook with the live powers computed once from `ir`, which
    pixel_colors calls once per call so that every level reuses them (the
    JAX package recomputes them at each hook call; the numbers are the
    same). Unbound, the hook computes them at each call."""
    pm_caustic = maps.get(CAUSTIC)
    pm_global = maps.get(GLOBAL)
    S = cfg.gi_usteps * cfg.gi_vsteps

    def hook(ir, rt, comps, rng):
        pmg, pmc = pm_global, pm_caustic
        if live_power:
            pmg, pmc = with_live_power(pmg, ir), with_live_power(pmc, ir)
        R = comps.p.shape[0]
        add = torch.zeros_like(comps.p)
        gate = (comps.over_Kd > 0.0).any(-1)
        if cfg.visualize_photon_map and pmg is not None:
            add = add + lighting_gi(ir, rt, pmg, comps, cfg)
        if cfg.include_final_gather and pmg is not None:
            k = RNG(0, comps.p.device) if rng is None else rng
            add = add + final_gather(
                ir, rt, pmg, comps,
                draw_gather(k.fold(99), S, R, comps.p.dtype), cfg)
        if cfg.include_caustics and pmc is not None:
            add = add + lighting_caustics(ir, rt, pmc, comps, cfg)
        return torch.where(gate[:, None], add, 0.0)

    if live_power:
        hook.bind = lambda ir: make_gi_hook(
            {m: with_live_power(pm, ir) for m, pm in maps.items()}, cfg)
    return hook
