"""photon_pass_ms.frame: the host wall of the photon pass,
photon.trace_photons (the photons' emission and bounce waves, and the
host build of both maps), per frame of the traced window, in ms; a
benchmark-side span around the render module's call, ended by a device
sync. Moves frame_s."""

import statistics


def spans(sp):
    from fast_ray_tracer_tpu_torch.render import photon
    orig = photon.trace_photons

    def trace_photons(*a, **k):
        with sp.span("photon_pass"):
            return orig(*a, **k)
    photon.trace_photons = trace_photons

    def undo():
        photon.trace_photons = orig
    return undo


def read(t):
    v = t.spans.get("photon_pass")
    return statistics.mean(v) * 1e3 if v else None
