"""Execution plans (port of ``repro/plan``): the kernel registry and the
compile-once / serve-many planning API.

* ``registry`` - the six ``KernelImpl``s: cost models against H100
  constants, capability gates, CUDA launch tiles and lowerings.
* ``plan`` - ``compile_plan(frozen_params, batch_profile) -> ModelPlan``,
  JSON save/load in the reference's format, per-bucket lookup.
* ``runtime`` - ``activate(plan)`` and the ``planned(k, m, n)`` lookup the
  serving step uses.
"""
from repro_torch.plan import registry, runtime  # noqa: F401
from repro_torch.plan.plan import (  # noqa: F401
    PLAN_VERSION,
    BatchProfile,
    LayerPlan,
    ModelPlan,
    compile_plan,
    compile_plan_from_shapes,
    format_plan,
)
