"""The H100 benchmark of ``repro_torch``, the PyTorch and CUDA port.

One general harness, driven by data: a cell (``BENCHMARK.json``
``workloads``) names a configuration file, a traffic file and a cell file
under ``bench_h100/``, and each metric is a reader of its own under
``bench_h100/metrics/``.  Modules:

* :mod:`spec`     -- find a cell, its files and its metrics by name;
* :mod:`weights`  -- the seeded latent weights both sides are given;
* :mod:`traffic`  -- the general load generator (requests from a seed);
* :mod:`loadgen`  -- drives ``ServingEngine.submit``/``step`` on the host
  clock, open or closed loop, and stamps every emitted token;
* :mod:`window`   -- the arithmetic of the measured window;
* :mod:`roofline` -- the H100's peaks, a projection's bound, model FLOPs;
* :mod:`profile`  -- the ``torch.profiler`` slice of a traced run;
* :mod:`check`    -- the comparison with the plain reference that decides
  ``correct``;
* :mod:`guard`    -- the rule that no JAX module is loaded;
* :mod:`cellrun`  -- one run of one cell, as ``bench_h100/run.py`` makes it.

Nothing here imports ``jax``, ``jaxlib``, ``flax``, ``repro`` or
``benchmarks``; ``repro_torch`` is imported by :mod:`cellrun` and
:mod:`loadgen` only, through its public entry points.
"""
