"""Hand-written Hopper kernels and their wrappers.

Only ``tsar_matmul`` is ported so far; ``tsar_lut_gemv`` and the two sparse
kernels of the reference package are still to come (see ROADMAP.md).
"""
