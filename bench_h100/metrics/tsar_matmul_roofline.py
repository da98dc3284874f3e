"""tsar_matmul_roofline (%): the least time of the profiled slice's
ternary projections (``h100bench.roofline.bound_s`` of every projection of
every layer at each step's planned rows) over the device time of the
slice's kernels named ``tsar_*``.  The work is counted from the plan, not
from launches, so a kernel that fuses projections is held to the same
work.  Layer: kernels (``kernels/ops.py``, ``csrc/tsar_*.cu``)."""


def read(run):
    sl = run.slice
    if not sl or not sl["tsar_s"] or not run.slice_bound_s:
        return None
    return 100.0 * run.slice_bound_s / sl["tsar_s"]
