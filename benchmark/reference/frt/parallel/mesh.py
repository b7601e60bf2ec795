"""Pixel-split data parallelism over a torch.distributed process group.

The counterpart of the JAX package's parallel/mesh.py. There a 1-D jax
`Mesh` names the devices of one program, and GSPMD or `shard_map` places
the pixel shards and inserts the collectives. torch runs one process per
device (SPMD): the process group is the mesh, each rank drives its own
device, and the code calls the collectives itself. So JAX's
single-process `make_mesh(8)` over 8 devices maps to 8 processes of one
group (`torchrun --nproc-per-node 8`, or `distributed.init` in each), and
a `PixelMesh` is this rank's view of that group.

The scene tables are replicated (every rank compiles the same scene or
receives rank 0's tables through `replicate_scene`), pixels shard over
the ranks in contiguous equal slices (`shard_pixel_batch`), and the
only communication is the per-chunk canvas gather of a render and the
gradient sum of a train step.

Which memory a collective takes is decided here and only here: under
gloo host tensors, under every other backend (NCCL) tensors on the
rank's device. It follows the backend the caller named when the group
was made (`torch.distributed.get_backend`).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

BATCH_AXIS = "batch"


class PixelMesh(NamedTuple):
    """This rank's view of a 1-D mesh over the process group `group`
    (the axis BATCH_AXIS): its rank, the group's size, and the device it
    renders on."""
    rank: int
    size: int
    device: torch.device
    group: Any


def make_mesh(n_devices: Optional[int] = None) -> PixelMesh:
    """The mesh over the default process group (`distributed.init` or
    `torch.distributed.init_process_group` made it), on the device
    `distributed.init` bound this rank to. `n_devices`, if given, must be
    the group's size."""
    from benchmark.reference.frt.parallel import distributed
    group = dist.group.WORLD
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices over a process "
                         f"group of {size} ranks: one rank per device")
    return PixelMesh(dist.get_rank(group), size, distributed.rank_device(),
                     group)


def _side(mesh: PixelMesh) -> torch.device:
    """Where the group's collectives take their tensors."""
    if dist.get_backend(mesh.group) == "gloo":
        return torch.device("cpu")
    return mesh.device


def _in_place(mesh: PixelMesh, t: torch.Tensor, collective) -> torch.Tensor:
    """Run `collective(buffer)` on `t`'s values where the group takes
    them, and leave the result in `t` (through a copy when `t` lies
    elsewhere: under gloo a device tensor goes through host memory)."""
    side = _side(mesh)
    if t.device == side:
        collective(t)
        return t
    buf = t.to(side)
    collective(buf)
    return t.copy_(buf)


def all_reduce_(mesh: PixelMesh, t: torch.Tensor,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce `t` over the mesh with `op`, in place; returns `t`."""
    return _in_place(mesh, t, lambda b: dist.all_reduce(b, op,
                                                        group=mesh.group))


def gather_rows(mesh: PixelMesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (the same shape on each), concatenated along the
    first axis in rank order, on every rank: on the host under gloo, on
    the rank's device otherwise."""
    src = t.detach().to(_side(mesh)).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts)


def shard_pixel_batch(mesh: PixelMesh, *arrays):
    """This rank's contiguous equal slice of each per-pixel array (first
    axis), on the mesh's device. A length the mesh does not divide
    raises, as a NamedSharding refuses it."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        n = t.shape[0]
        if n % mesh.size:
            raise ValueError(f"a batch of {n} does not split evenly over "
                             f"{mesh.size} ranks")
        per = n // mesh.size
        out.append(t[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]


def _tensors(tree):
    """The tensors of a dict, SceneIR, TrainState (its parameters, then
    its optimizer's state in the order of its parameter groups), tuple or
    list, in an order every rank agrees on."""
    from benchmark.reference.frt.parallel.train import TrainState
    from benchmark.reference.frt.scene.ir import SceneIR
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, np.ndarray):
        raise TypeError("replicate_scene broadcasts tensors in place; "
                        "convert numpy arrays with torch.as_tensor first")
    elif isinstance(tree, SceneIR):
        yield from _tensors(tree.tables())
    elif isinstance(tree, TrainState):
        yield from _tensors(tree.params)
        opt = tree.optimizer
        for group in opt.param_groups:
            for p in group["params"]:
                state = opt.state.get(p, {})
                yield from _tensors({k: state[k] for k in sorted(state)})
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def replicate_scene(mesh: PixelMesh, tree):
    """Broadcast every tensor of `tree` (a dict, SceneIR or TrainState)
    from rank 0, in place, so every rank holds rank 0's values; returns
    `tree`."""
    with torch.no_grad():
        for t in _tensors(tree):
            if t.numel():
                _in_place(mesh, t, lambda b: dist.broadcast(
                    b, 0, group=mesh.group))
    return tree
