"""backward_device_ms.step: the device time of the work enqueued after
make_train_step's `between` callback, which runs after the forward, until
the step returns (the backward and Adam), per profiled step, in ms: the
kernels whose launching operator began after the callback (autograd runs
the backward on its own thread). It reads no kernel names, so it holds
whatever kernels the backward uses. Moves step_s."""


def read(t):
    marked = [u.after_mark for u in t.units if u.after_mark is not None]
    if not marked or not sum(marked):
        return None
    return sum(marked) / len(marked) * 1e3
