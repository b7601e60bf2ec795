"""Differentiable training step: inverse rendering over scene parameters.

Pixel-loss gradients flow to every continuous scene parameter: material
tables (Ka/Kd/Ks/Tf/refl/Ns/Ni/Tr), light intensities and positions,
pattern colors and transforms, primitive inverse transforms, triangle
vertices (clustered meshes too, through the mesh hit's t) and texture
texels, and through photon-mapped GI's live photon powers to the light
and material tables. Discrete structure (hit selection, type ids, shadow
ranks, the photon map's photons) is integer or boolean or frozen and
selected through `torch.where`, so it carries no gradient.

`build_statics` runs once on the starting scene, as in the JAX package:
the tables it derives (each slot's primitive, each primitive's
refractive index for the containers walk, a clustered mesh's cluster
boxes) stay fixed during training; the mesh's triangle planes follow the
live vertices (render.pixel_colors).

The step is data-parallel over pixels with a `mesh` (parallel/mesh.py):
each rank renders its shard of the batch, its loss is its shard's share
of the mean over the whole batch, and after the backward the gradients
are summed over the ranks, so every rank takes the same optimizer step
from the whole batch's gradient. In the JAX package GSPMD inserts that
all-reduce; here the step calls it.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.parallel.mesh import PixelMesh, all_reduce_
from fast_ray_tracer_tpu_torch.render.render import pixel_colors
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR
from fast_ray_tracer_tpu_torch.utils.profiling import span, unit

# float tables that are acceleration structure, not parameters
NON_TRAINABLE = frozenset({"cluster_min", "cluster_max"})


def split_params(ir: SceneIR) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(params, static): every float table but NON_TRAINABLE's as a leaf
    tensor that requires grad (a copy, so training never writes into
    `ir`), and the integer and bool tables with `meta` as the static
    part. Clear `requires_grad` on a parameter to freeze it."""
    params, fields = {}, {}
    for name, t in ir.tables().items():
        if t.is_floating_point() and name not in NON_TRAINABLE:
            params[name] = t.detach().clone().requires_grad_(True)
        else:
            fields[name] = t
    return params, {"fields": fields, "meta": ir.meta}


def merge_params(params: Dict[str, torch.Tensor], static) -> SceneIR:
    return SceneIR(meta=static["meta"], **static["fields"], **params)


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]     # leaf tensors
    optimizer: torch.optim.Optimizer    # over the params requiring grad


def adam(params, lr: float = 1e-2) -> torch.optim.Optimizer:
    """The default optimizer: Adam with the JAX package's optax.adam(1e-2)
    hyperparameters (betas 0.9/0.999, eps 1e-8 outside the square root)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def trainable(params: Dict[str, torch.Tensor]):
    """The parameters the optimizer updates, in the dict's order."""
    return [p for p in params.values() if p.requires_grad]


def sum_gradients(mesh: PixelMesh, params: Dict[str, torch.Tensor]) -> None:
    """Sum the trainable parameters' gradients over the mesh, in place: one
    flat buffer and one all-reduce per dtype (a parameter without a
    gradient on this rank contributes zeros). Under NCCL the buffer stays
    on the device and nothing waits for the host; under gloo it goes
    through host memory, which syncs the stream."""
    ps = trainable(params)
    for dtype in dict.fromkeys(p.dtype for p in ps):
        group = [p for p in ps if p.dtype == dtype]
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                          .reshape(-1) for p in group])
        all_reduce_(mesh, flat)
        for p, g in zip(group, flat.split([p.numel() for p in group])):
            p.grad = g.view_as(p)


def make_train_step(rt, cam_rt, static, n_samples: int, path_length: int,
                    optimizer: Optional[Callable] = None, remat=False,
                    buckets=None, mesh: Optional[PixelMesh] = None):
    """-> (init, step). `init(params)` makes a TrainState whose optimizer
    (`optimizer(list_of_tensors)`, default `adam`) updates the parameters
    that require grad; the others stay frozen. `step(state, px, py, uv,
    ap, target, rng=None)` renders the pixels (`pixel_colors`, with `rng`
    the trace's RNG node, as the JAX package's step takes `key`: a scene
    that draws, photon GI's final gather among them, needs one), takes the
    MSE against `target` (n_pixels, 3), back-propagates and updates the
    parameters in place; it returns (state, loss, overflow), both 0-d
    tensors on the device, without a host sync (one train step is the
    tracer's unit `train.step`, with the spans `train.forward`,
    `train.backward` and `train.optimizer`). It raises nothing on
    overflow: a True flag means the bucketed trace dropped rays and the
    step's gradient is incomplete, and the caller decides. `between`, if
    given, is called after the forward and before the backward (for
    instrumentation). `remat` and `buckets` go to pixel_colors. With
    photon GI, `rt.gi_hook` comes from make_gi_hook(..., live_power=True)
    for gradients through the photon map.

    With `mesh`, every rank calls `step` with its shard of the batch
    (parallel/mesh.shard_pixel_batch, the same count on every rank) and
    a state that holds the same values on every rank
    (mesh.replicate_scene): the loss is the shard's squared error over
    the whole batch's element count, the gradients are summed over the
    ranks (`sum_gradients`), and the returned loss (summed) and overflow
    (the largest) are the whole batch's, the same on every rank."""
    make_opt = adam if optimizer is None else optimizer

    def init(params: Dict[str, torch.Tensor]) -> TrainState:
        return TrainState(params, make_opt(trainable(params)))

    def loss_fn(params, px, py, uv, ap, target, rng):
        img, overflow = pixel_colors(
            merge_params(params, static), rt, cam_rt, px, py, uv, ap,
            n_samples, path_length, remat=remat, buckets=buckets, rng=rng)
        if mesh is None:
            return torch.mean((img - target) ** 2), overflow
        return (torch.sum((img - target) ** 2)
                / (target.numel() * mesh.size)), overflow

    def step(state: TrainState, px, py, uv, ap, target, rng=None,
             between=None):
        with unit("train.step"):
            state.optimizer.zero_grad(set_to_none=True)
            with span("train.forward"):
                loss, overflow = loss_fn(state.params, px, py, uv, ap,
                                         target, rng)
            if between is not None:
                between()
            with span("train.backward"):
                loss.backward()
                loss = loss.detach()
                if mesh is not None:
                    sum_gradients(mesh, state.params)
                    loss = all_reduce_(mesh, loss.reshape(1))[0]
                    overflow = all_reduce_(
                        mesh, overflow.to(torch.int32).reshape(1),
                        torch.distributed.ReduceOp.MAX)[0].bool()
            with span("train.optimizer"):
                state.optimizer.step()
        return state, loss, overflow

    return init, step


def train_state_from_numpy(params: Dict[str, np.ndarray],
                           mu: Dict[str, np.ndarray],
                           nu: Dict[str, np.ndarray], count: int,
                           device, dtype) -> TrainState:
    """A TrainState from numpy arrays keyed by field name: the JAX
    package's parameters and its optax Adam state (`mu`, `nu`, `count`),
    e.g. `np.asarray` of each leaf. The parameters named in `mu` train
    under `adam()` (optax.adam(1e-2)'s counterpart), whose `state` holds
    mu as `exp_avg`, nu as
    `exp_avg_sq` and count as `step`; the others are frozen. Float
    arrays become `dtype` on `device`, as in `scene_ir_from_numpy`."""
    def tensor(a):
        # a writable copy: the optimizer updates the parameters in place
        return torch.as_tensor(np.array(a, np.float64)).to(device=device,
                                                            dtype=dtype)

    ps = {k: tensor(v).requires_grad_(k in mu) for k, v in params.items()}
    opt = adam(trainable(ps))
    for k in mu:
        opt.state[ps[k]] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": tensor(mu[k]), "exp_avg_sq": tensor(nu[k])}
    return TrainState(ps, opt)
