"""launches_step (launches): kernel launch calls (``cudaLaunchKernel``,
``cuLaunchKernel``, ``cudaLaunchKernelExC``) in the profiled slice over
its steps (``h100bench.spans``).  Layer: model step: the host's dispatch
work, which bounds a host-bound step."""
from h100bench import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    return sp["launches"] / sp["steps"]
