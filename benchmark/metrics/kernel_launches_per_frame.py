"""kernel_launches_per_frame: host-side launch calls per profiled frame
(cudaLaunchKernel*, cuLaunchKernel*, cudaLaunchCooperativeKernel*; a
cudaGraphLaunch counts one), from the profiler's host events. A CUDA
graph or fused kernels lower it. Moves frame_s."""


def read(t):
    if not t.units:
        return None
    n = t.total("launches")
    return n / len(t.units) if n else None
