"""Hand-written Hopper kernels and their wrappers.

Every TPU kernel of the reference package has its counterpart here:
``tsar_matmul`` (``csrc/tsar_matmul.cu``), the padded and compacted
block-sparse kernels (two entry points of ``csrc/tsar_sparse.cu``) and
``tsar_lut`` (``csrc/tsar_lut.cu``).  ``_build.SOURCES`` lists the three
libraries.
"""
