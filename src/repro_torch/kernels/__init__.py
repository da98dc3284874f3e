"""Hand-written Hopper kernels and their wrappers.

Ported: ``tsar_matmul`` and ``tsar_sparse_padded`` (the padded-pool sparse
kernel).  ``tsar_lut_gemv`` and the compacted ``tsar_sparse_matmul_packed``
of the reference package come with the ``core/bitlinear`` slice (see
ROADMAP.md).
"""
