"""The JAX package's `parallel` exports: the pixel mesh and the train step.

They load on first use (`render.render` imports `parallel.checkpoint`,
and `parallel.train` imports `render.render`, so importing them here
would be circular).
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh", "replicate_scene": "mesh",
    "shard_pixel_batch": "mesh",
    "make_train_step": "train", "merge_params": "train",
    "split_params": "train",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
