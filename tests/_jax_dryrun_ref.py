"""The reference's dry-run on four host devices, for
``tests/test_torch_dryrun_mesh.py``.

Run as a script in its own process (the test process already holds a
one-device JAX):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/_jax_dryrun_ref.py cells.json outputs.json

``cells.json`` maps a name to (arch, shape fields, weights, fsdp); per cell
the reference's ``lower_cell`` is compiled for a (2, 2) mesh of Auto axes
(``jax.make_mesh`` gives Explicit ones, on which the reference's
``constrain`` raises) with the activation mesh set as its ``run_cell`` sets
it, and the output holds XLA's per-device ``argument_size_in_bytes`` and
the collective bytes by kind that ``roofline.hlo_program_costs`` reads
from the partitioned module.  The reduced configs are used.
"""
from __future__ import annotations

import json
import sys

import jax
import numpy as np
from jax.sharding import AxisType


def main(inp: str, out: str) -> None:
    devices = jax.devices()            # the device count is fixed here, before
    from repro.launch.dryrun import lower_cell  # this import sets XLA_FLAGS

    import repro.configs as jconfigs
    from repro.launch import roofline
    from repro.utils import act_sharding

    with open(inp) as f:
        cells = json.load(f)
    mesh = jax.sharding.Mesh(np.array(devices[:4]).reshape(2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
    res = {}
    act_sharding.set_mesh(mesh)
    try:
        for name, (arch, fields, weights, fsdp) in cells.items():
            lowered, _ = lower_cell(jconfigs.get(arch).reduced(),
                                    jconfigs.ShapeConfig(*fields), mesh, weights=weights,
                                    fsdp=fsdp)
            compiled = lowered.compile()
            res[name] = {
                "argument_size_in_bytes": compiled.memory_analysis().argument_size_in_bytes,
                "collectives": roofline.hlo_program_costs(compiled.as_text())["collectives"]}
    finally:
        act_sharding.set_mesh(None)
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
