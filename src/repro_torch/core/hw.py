"""NVIDIA H100 SXM hardware constants for the planner's cost models (port of
``repro/core/hw.py``).

The reference holds TPU v5e constants; the port's planner costs kernels
against the H100 SXM data sheet (dense rates, at the full 700 W power limit):
989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s HBM3, 132 SMs, and 228 KiB of
shared memory per SM in place of the TPU's VMEM.  ``NVLINK_BW`` is NVLink 4's
450 GB/s per direction per GPU (the data sheet's 900 GB/s counts both
directions), the link rate the dry-run roofline's collective term divides
by in place of the TPU's ICI link.  ``chip_smoke.py`` prints them
beside ``torch.cuda.get_device_properties(0)``.

``SPARSE_ISSUE_TAX`` and ``SPARSE_PAD_STEP_FRAC`` and the calibration API
below are kept as the reference has them: they are analytic defaults of the
cost formulas, not measurements taken on a TPU, and a measured machine
overrides them through ``set_calibration`` without touching the formulas.
"""
from __future__ import annotations

import json

PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_INT8 = 1979e12      # int8 ops/s, dense tensor cores
HBM_BW = 3.35e12               # bytes/s
NVLINK_BW = 450e9              # bytes/s per direction per GPU (NVLink 4)
SMEM_BYTES = 228 * 1024        # shared memory per SM
SM_COUNT = 132                 # streaming multiprocessors

# Issue-efficiency tax on the sparse kernels' live-block work (analytic
# default; see module docstring).  Puts the break-even near 1/1.1 ~ 0.9 live
# blocks instead of degenerately at 1.0.
SPARSE_ISSUE_TAX = 1.1

# Cost of one masked walk step in the padded-pool sparse kernel, as a
# fraction of a live block's compute.  The reference's Pallas grid issues
# every one of the static s_steps; the port's CUDA walk stops at counts[j],
# but the constant stays so that both packages plan alike.
SPARSE_PAD_STEP_FRAC = 0.05

# Calibratable keys and their analytic defaults.  Values installed via
# set_calibration() shadow the module constants for every reader that goes
# through the accessor functions (the kernel registry cost models do).
_CALIBRATION_DEFAULTS = {
    "sparse_issue_tax": SPARSE_ISSUE_TAX,
    "sparse_pad_step_frac": SPARSE_PAD_STEP_FRAC,
}
_CALIBRATED: dict[str, float] = {}


def sparse_issue_tax() -> float:
    """The live value: calibrated if installed, else the analytic default."""
    return _CALIBRATED.get("sparse_issue_tax", SPARSE_ISSUE_TAX)


def sparse_pad_step_frac() -> float:
    return _CALIBRATED.get("sparse_pad_step_frac", SPARSE_PAD_STEP_FRAC)


def set_calibration(**values: float) -> None:
    """Install measured cost-model constants (the reference's
    ``benchmarks/bench_kernels.py --calibrate`` writes them).  Unknown keys / non-positive values are
    rejected loudly — a typo'd calibration silently reverting to defaults
    would defeat the point."""
    for key, val in values.items():
        if key not in _CALIBRATION_DEFAULTS:
            raise ValueError(
                f"unknown calibration key {key!r}; known: "
                f"{sorted(_CALIBRATION_DEFAULTS)}")
        val = float(val)
        if not val > 0.0:
            raise ValueError(f"calibration {key}={val!r} must be > 0")
        _CALIBRATED[key] = val


def clear_calibration(*keys: str) -> None:
    """Drop calibrated values (all of them when called with no args)."""
    if not keys:
        _CALIBRATED.clear()
        return
    for key in keys:
        _CALIBRATED.pop(key, None)


def calibration() -> dict[str, float]:
    """The effective constants (defaults overlaid with calibrated values)."""
    out = dict(_CALIBRATION_DEFAULTS)
    out.update(_CALIBRATED)
    return out


def save_calibration(path, values: dict | None = None) -> None:
    """Write the calibration JSON ``load_calibration`` consumes.

    ``values`` defaults to the currently installed calibration; an explicit
    dict (validated against the known keys) lets a fit be persisted without
    installing it process-globally — either way this function is the one
    writer of the file format.
    """
    if values is None:
        values = dict(_CALIBRATED)
    else:
        for key, val in values.items():
            if key not in _CALIBRATION_DEFAULTS:
                raise ValueError(
                    f"unknown calibration key {key!r}; known: "
                    f"{sorted(_CALIBRATION_DEFAULTS)}")
            if not float(val) > 0.0:
                raise ValueError(f"calibration {key}={val!r} must be > 0")
    with open(path, "w") as f:
        json.dump({"version": 1, "calibration": dict(values)}, f, indent=2)


def load_calibration(path) -> dict[str, float]:
    with open(path) as f:
        payload = json.load(f)
    if payload.get("version") != 1:
        raise ValueError(f"calibration version {payload.get('version')!r} != 1")
    set_calibration(**payload["calibration"])
    return dict(payload["calibration"])
