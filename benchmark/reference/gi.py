"""The photon-GI cells' reference: a photon map whose memory follows its
photons.

The frozen reference (`frt/`) builds a dense grid over the box that
bounds every stored photon. Photons that leave an open scene land far
out on its infinite planes, so at a million photons that grid can ask for
more memory than the host has, and its size depends on the seed. This
module's build keeps the frozen build's cell arithmetic (the same origin,
dims, cell ids and stable order, on the host in the photons' own
precision) and keeps tables for the occupied cells alone; a query finds
its 27 cells among them, with the extents a dense CSR would give. The
most photons of any cell's 27-cell block is counted by brute force: every
cell next to an occupied one, each block summed by lookups. `installed()`
puts both in the frozen photon module's place while a reference frame
renders; the frozen estimate, trace and render run unchanged. Nothing
here imports the port.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference.frt.render import photon as P

_OFFSETS = np.array([(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
                     for oz in (-1, 0, 1)], np.int64)
# cells looked up at once in the block count
_BLOCK = 1 << 18


class GridMap(NamedTuple):
    """The frozen PhotonMap's fields, with `keys` (the occupied cells' ids,
    ascending) and `row_start` over those cells alone."""
    pos: torch.Tensor
    power: torch.Tensor
    dirs: torch.Tensor
    keys: torch.Tensor
    row_start: torch.Tensor
    grid_origin: tuple
    cell_size: float
    dims: tuple
    n: int
    max_neighbors: int
    prov_light: Optional[torch.Tensor] = None
    prov_mat: Optional[torch.Tensor] = None
    prov_code: Optional[torch.Tensor] = None
    prov_samp: Optional[torch.Tensor] = None
    power_div: float = 1.0


def _ravel(ijk, dims):
    return (ijk[..., 0] * dims[1] + ijk[..., 1]) * dims[2] + ijk[..., 2]


def _lookup(keys, row_start, ids, inb):
    """(starts, ends) of the cells `ids` (any shape) among the occupied
    `keys`: a dense CSR's extents; cells outside the grid (`inb` false)
    are empty at 0."""
    m = keys.shape[0]
    at = torch.searchsorted(keys, ids)
    hit = inb & (keys[at.clamp(max=m - 1)] == ids)
    s = torch.where(inb, row_start[at], 0)
    return s, torch.where(hit, row_start[(at + 1).clamp(max=m)], s)


def _block_max(keys, counts, dims) -> int:
    """The most photons in any in-grid cell's 27-cell block: each cell
    within one step of an occupied cell, its block's counts looked up."""
    dev = keys.device
    d = torch.tensor(dims, device=dev)
    offs = torch.as_tensor(_OFFSETS, device=dev)
    ijk = torch.stack([keys // (d[1] * d[2]), keys // d[2] % d[1],
                       keys % d[2]], -1)
    near = (ijk[:, None] + offs).reshape(-1, 3)
    near = torch.unique(_ravel(near[((near >= 0) & (near < d)).all(-1)], d))
    row_start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           torch.cumsum(counts, 0)])
    best = 0
    for lo in range(0, near.shape[0], _BLOCK):
        c = near[lo:lo + _BLOCK]
        cell = torch.stack([c // (d[1] * d[2]), c // d[2] % d[1], c % d[2]],
                           -1)[:, None] + offs
        inb = ((cell >= 0) & (cell < d)).all(-1)
        s, e = _lookup(keys, row_start, _ravel(cell, d), inb)
        best = max(best, int((e - s).sum(1).max()))
    return best


def build_photon_map(pos: np.ndarray, power: np.ndarray, dirs: np.ndarray,
                     radius: float, dtype, device, prov: Optional[dict] = None,
                     power_div: float = 1.0) -> Optional[GridMap]:
    """The frozen build_photon_map's map, with tables over the occupied
    cells alone. None when no photon was stored."""
    n = len(pos)
    if n == 0:
        return None
    origin = pos.min(axis=0) - 1e-6
    extent = pos.max(axis=0) - origin + 1e-6
    dims = np.maximum(1, np.ceil(extent / radius).astype(np.int64) + 1)
    cell = np.minimum(np.floor((pos - origin) / radius).astype(np.int64),
                      dims - 1)
    cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = np.argsort(cid, kind="stable")
    keys, counts = np.unique(cid, return_counts=True)
    dims = tuple(int(x) for x in dims)
    tkeys = torch.as_tensor(keys).to(device)
    tcounts = torch.as_tensor(counts).to(device)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a[order])).to(
            device=device, dtype=dt)
    extra = {}
    if prov is not None:
        extra = dict(prov_light=dev(prov["light"], torch.int64),
                     prov_mat=dev(prov["mat"], torch.int64),
                     prov_code=dev(prov["code"], torch.int64),
                     prov_samp=None if prov.get("samp") is None
                     else dev(prov["samp"]), power_div=float(power_div))
    return GridMap(
        pos=dev(pos), power=dev(power), dirs=dev(dirs), keys=tkeys,
        row_start=torch.cat([torch.zeros(1, dtype=torch.int64,
                                         device=device),
                             torch.cumsum(tcounts, 0)]),
        grid_origin=tuple(float(x) for x in origin), cell_size=float(radius),
        dims=dims, n=n, max_neighbors=_block_max(tkeys, tcounts, dims),
        **extra)


def neighbor_extents(pm: GridMap, points):
    """The frozen _neighbor_extents' (starts, ends), each (R, 27), from the
    occupied cells' tables."""
    dev, dtype = points.device, points.dtype
    org = torch.tensor(pm.grid_origin, dtype=dtype, device=dev)
    hi = torch.tensor([d - 1 for d in pm.dims], dtype=dtype, device=dev)
    # clamp before the integer conversion: parked points (1e30) overflow it
    cell = torch.minimum(torch.floor((points - org) / pm.cell_size)
                         .clamp(min=0.0), hi).to(torch.int64)
    c = cell[:, None, :] + torch.as_tensor(_OFFSETS, device=dev)[None]
    d = torch.tensor(pm.dims, dtype=torch.int64, device=dev)
    inb = ((c >= 0) & (c < d)).all(-1)
    return _lookup(pm.keys, pm.row_start, _ravel(c, d), inb)


@contextlib.contextmanager
def installed():
    """The frozen photon module with this module's map build and lookup."""
    saved = P.build_photon_map, P._neighbor_extents
    P.build_photon_map, P._neighbor_extents = build_photon_map, \
        neighbor_extents
    try:
        yield
    finally:
        P.build_photon_map, P._neighbor_extents = saved

