"""compile_scene_ms.frame: the host wall of compile_scene, which every
render_scene call runs (scene tables, camera, statics), per frame of the
traced window, in ms; a benchmark-side span around the render module's
call, ended by a device sync. Moves frame_s."""

import statistics


def spans(sp):
    from fast_ray_tracer_tpu_torch.render import render as R
    orig = R.compile_scene

    def compile_scene(*a, **k):
        with sp.span("compile_scene"):
            return orig(*a, **k)
    R.compile_scene = compile_scene

    def undo():
        R.compile_scene = orig
    return undo


def read(t):
    v = t.spans.get("compile_scene")
    return statistics.mean(v) * 1e3 if v else None
