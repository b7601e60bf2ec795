"""forward_device_ms.step: the device time of the kernels inside the
program's profiler range `train.forward` (parallel/train.py: the
forward of make_train_step's step, the render of the batch and its
loss), per profiled step, in ms. A program without the range reads
nothing. Moves step_s."""

RANGE = "train.forward"


def read(t):
    v = [u.in_range[RANGE] for u in t.units if RANGE in u.in_range]
    if not v or not sum(v):
        return None
    return sum(v) / len(v) * 1e3
