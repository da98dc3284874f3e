"""mfu (%): the model FLOPs that the window's processed tokens need
(``h100bench.roofline.flops``) over the window's seconds x the H100's int8
peak, 1,979 TOP/s.  Layer: model step, the whole of it."""
from h100bench import roofline


def read(run):
    if not run.flops:
        return None
    return 100.0 * run.flops / (run.seconds * roofline.INT8_OPS_PER_S)
