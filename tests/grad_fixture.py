"""Shared set-up of the port's gradient tests: one scene's frame, one
sample per pixel with a point aperture, in float64 in both packages, with
the MSE loss of `pixel_colors` over every key of `split_params`.

The port's SceneIR is built from the JAX one (`scene_convert.ir_from_jax`),
so both packages start from the same parameters. Targets are rendered by
the port and handed to both sides as numpy. The JAX gradient is one
`jax.jit(jax.value_and_grad(...))` per call: its eager grad at depth 5 is
minutes on the CPU, its jit tens of seconds, almost all of it compile
time, so each test module calls it once."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from fast_ray_tracer_tpu.parallel import train as jtrain
from fast_ray_tracer_tpu.render import camera as jcam
from fast_ray_tracer_tpu.render import integrator as jintg
from fast_ray_tracer_tpu.render import render as jrender
from fast_ray_tracer_tpu.sampling.cmj import cmj_points_static
from fast_ray_tracer_tpu.scene import compile as jcomp
from fast_ray_tracer_tpu.scene import model as jmodel

from fast_ray_tracer_tpu_torch.parallel import train as ttrain
from fast_ray_tracer_tpu_torch.render import camera as tcam
from fast_ray_tracer_tpu_torch.render import integrator as tintg
from fast_ray_tracer_tpu_torch.render import render as trender
from tests.scene_convert import convert, ir_from_jax

# the keys of split_params on every scene of these tests: the SceneIR's
# float tables but cluster_min/cluster_max
PARAM_KEYS = (
    "inv_tf", "light_intensity", "light_normal", "light_points", "light_pos",
    "light_radius", "light_uvec", "light_vvec", "mat_Ka", "mat_Kd",
    "mat_Ks", "mat_Ni", "mat_Ns", "mat_Tf", "mat_Tr", "mat_refl",
    "pat_colors", "pat_inv_tf", "pat_params", "prim_params", "tex_data",
    "tri_e1", "tri_e2", "tri_n1", "tri_n2", "tri_n3", "tri_p1", "tri_t1",
    "tri_t2", "tri_t3")


class Frame:
    """A port SceneDesc's W x H frame in both packages, float64."""

    def __init__(self, scene):
        jsc = convert(scene, jmodel)
        cam = scene.camera
        self.W, self.H = cam.width, cam.height
        self.n = n = self.W * self.H
        self.depth = scene.config.di_path_length
        self.jir = jcomp.compile_scene(jsc, dtype=jnp.float64)
        self.jrt = jintg.build_statics(self.jir, jsc.config)
        self.jcam = jcam.build_camera(jsc.camera, dtype=jnp.float64)
        self.ir = ir_from_jax(self.jir, "cpu", torch.float64)
        self.rt = tintg.build_statics(self.ir, scene.config)
        self.cam = tcam.build_camera(cam, dtype=torch.float64, device="cpu")
        px = np.tile(np.arange(self.W), self.H)
        py = np.repeat(np.arange(self.H), self.W)
        uv = np.broadcast_to(cmj_points_static(1, 1), (n, 2)).copy()
        self.np_args = (px.astype(np.int32), py.astype(np.int32), uv,
                        np.zeros((n, 2)))
        self.args = (torch.as_tensor(px), torch.as_tensor(py),
                     torch.as_tensor(uv), torch.zeros((n, 2),
                                                      dtype=torch.float64))
        self.params, self.static = ttrain.split_params(self.ir)
        self.jparams, self.jstatic = jtrain.split_params(self.jir)

    def colors(self, params=None, **kw):
        """The port's (colors, overflow) at `params` (default: the
        scene's)."""
        ir = self.ir if params is None else ttrain.merge_params(
            params, self.static)
        return trender.pixel_colors(ir, self.rt, self.cam, *self.args, 1,
                                    self.depth, **kw)

    def target(self, scale=0.9, offset=0.01, params=None):
        """A target the loss is not flat at: the frame times `scale` plus
        `offset`, as numpy."""
        with torch.no_grad():
            img, _ = self.colors(params)
        return img.numpy() * scale + offset

    def port_loss(self, params, target, **kw):
        img, overflow = self.colors(params, **kw)
        return torch.mean((img - torch.as_tensor(target)) ** 2), overflow

    def port_grads(self, target, **kw):
        """(loss, {key: gradient}) of the port, every key of split_params."""
        loss, _ = self.port_loss(self.params, target, **kw)
        keys = sorted(self.params)
        gs = torch.autograd.grad(loss, [self.params[k] for k in keys],
                                 allow_unused=True)
        return float(loss.detach()), {
            k: (torch.zeros_like(self.params[k]) if g is None else g).numpy()
            for k, g in zip(keys, gs)}

    def jax_grads(self, target, **kw):
        """(loss, {key: gradient}) of the JAX package, in one jit."""
        jt = jnp.asarray(target)

        def loss(p):
            img = jrender.pixel_colors(
                jtrain.merge_params(p, self.jstatic), self.jrt, self.jcam,
                *self.np_args, 1, self.depth, None, **kw)
            return jnp.mean((img - jt) ** 2)

        value, grads = jax.jit(jax.value_and_grad(loss))(self.jparams)
        return float(value), {k: np.array(v) for k, v in grads.items()}


def assert_grad_close(got, want, name, rtol=1e-9, atol=1e-12):
    """|got - want| <= rtol * max|want| + atol over the whole field."""
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.size == 0:
        return
    err = float(np.abs(got - want).max())
    bound = rtol * float(np.abs(want).max()) + atol
    assert err <= bound, (name, err, bound)
