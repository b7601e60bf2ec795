"""Differentiable training step: inverse rendering over scene parameters.

Pixel-loss gradients flow to every continuous scene parameter: material
tables (Ka/Kd/Ks/Tf/refl/Ns/Ni/Tr), light intensities and positions,
pattern colors and transforms, primitive inverse transforms, triangle
vertices and texture texels. Discrete structure (hit selection, type ids,
shadow ranks) is integer or boolean and selected through `torch.where`,
so it carries no gradient.

`build_statics` runs once on the starting scene, as in the JAX package:
the tables it derives (each slot's primitive, each primitive's
refractive index for the containers walk) stay fixed during training.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fast_ray_tracer_tpu_torch.render.render import pixel_colors
from fast_ray_tracer_tpu_torch.scene.ir import SceneIR

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


def make_train_step(rt, cam_rt, static, n_samples: int, path_length: int,
                    optimizer: Optional[Callable] = None, remat=False,
                    buckets=None):
    """-> (init, step). `init(params)` makes a TrainState whose optimizer
    (`optimizer(list_of_tensors)`, default `adam`) updates the parameters
    that require grad; the others stay frozen. `step(state, px, py, uv,
    ap, target)` renders the pixels (`pixel_colors`), takes the MSE
    against `target` (n_pixels, 3), back-propagates and updates the
    parameters in place; it returns (state, loss, overflow), both 0-d
    tensors on the device, without a host sync. It raises nothing on
    overflow: a True flag means the bucketed trace dropped rays and the
    step's gradient is incomplete, and the caller decides. `between`, if
    given, is called after the forward and before the backward (for
    instrumentation). `remat` and `buckets` go to pixel_colors."""
    make_opt = adam if optimizer is None else optimizer

    def init(params: Dict[str, torch.Tensor]) -> TrainState:
        return TrainState(params, make_opt(trainable(params)))

    def loss_fn(params, px, py, uv, ap, target):
        img, overflow = pixel_colors(
            merge_params(params, static), rt, cam_rt, px, py, uv, ap,
            n_samples, path_length, remat=remat, buckets=buckets)
        return torch.mean((img - target) ** 2), overflow

    def step(state: TrainState, px, py, uv, ap, target, between=None):
        state.optimizer.zero_grad(set_to_none=True)
        loss, overflow = loss_fn(state.params, px, py, uv, ap, target)
        if between is not None:
            between()
        loss.backward()
        state.optimizer.step()
        return state, loss.detach(), overflow

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
