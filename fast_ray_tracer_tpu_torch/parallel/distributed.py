"""Multi-process entry points: one process per device, over torch.distributed.

The counterpart of the JAX package's parallel/distributed.py. There
`jax.distributed.initialize()` makes every host's chips one global mesh;
here every device gets a process of its own, and `init` joins it to the
default process group and binds it to its device. The scene is
replicated, pixels shard over the ranks (parallel/mesh.py), and every
rank receives the whole canvas.

A typical script, one process per GPU, started by
`torchrun --nproc-per-node 8 render.py` (which fills the `env://`
rendezvous and LOCAL_RANK):

    from fast_ray_tracer_tpu_torch.parallel import distributed as dist
    dist.init()
    canvas = render_scene(scene, mesh=dist.global_mesh())
    dist.shutdown()

Without torchrun, pass the rendezvous explicitly: a coordinator
`host:port` (a TCP store) or a `file://` store, the process count and
this process' id. The backend is the caller's: NCCL by default; gloo
takes its collectives through host memory (what two ranks sharing one
card, or CPU ranks, use).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from fast_ray_tracer_tpu_torch.parallel.mesh import PixelMesh, make_mesh

# the device `init` bound this process to
_rank_device: Optional[torch.device] = None


def _device_for(local_device_ids, process_id) -> torch.device:
    if local_device_ids == "cpu":
        return torch.device("cpu")
    if local_device_ids is not None:
        return torch.device("cuda", int(list(local_device_ids)[0]))
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", 0 if process_id is None else int(process_id))


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         local_device_ids=None, backend: str = "nccl") -> None:
    """Join the default process group (torch.distributed's
    init_process_group) and bind this process to its device.

    With no arguments the rendezvous is `env://` (torchrun's
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK). A coordinator
    `host:port` becomes `tcp://host:port`; an address that already names
    a scheme (`file:///path`) is passed as it is. The device is
    `cuda:<local_device_ids[0]>`, else `cuda:$LOCAL_RANK`, else
    `cuda:<process_id>`; `local_device_ids="cpu"` keeps the rank on the
    CPU (with `backend="gloo"`)."""
    global _rank_device
    if coordinator_address is None:
        method = "env://"
    elif "://" in coordinator_address:
        method = coordinator_address
    else:
        method = f"tcp://{coordinator_address}"
    device = _device_for(local_device_ids, process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=method, **kw)
    _rank_device = device


def rank_device() -> torch.device:
    """The device `init` bound this process to (without `init`: the
    current CUDA device)."""
    if _rank_device is not None:
        return _rank_device
    return torch.device("cuda", torch.cuda.current_device())


def shutdown() -> None:
    """Leave the process group."""
    global _rank_device
    dist.destroy_process_group()
    _rank_device = None


def global_mesh() -> PixelMesh:
    """The mesh over every rank of the default process group."""
    return make_mesh()


def process_shard(n: int):
    """This process' [lo, hi) slice of a length-n batch axis evenly
    sharded over the processes (host-side data feeding); the whole axis
    without a process group."""
    if dist.is_available() and dist.is_initialized():
        nproc, pid = dist.get_world_size(), dist.get_rank()
    else:
        nproc, pid = 1, 0
    per = -(-n // nproc)
    return pid * per, min(n, (pid + 1) * per)
