"""Port vs reference: the cross-kernel conformance grid through the port.

The reference's grid (``tests/test_conformance.py``: ``KERNEL_CASES``,
``SHAPES``, ``DENSITIES`` and its fixture layer, which carries every
kernel's encoding) is carried across with ``bridge.frozen_from_reference``
and run through the port's ``core.bitlinear.apply_frozen(plan=<kernel>)``
for every registry kernel, held against the port's own oracles:

* the int8 family (``exact=True``) bit-identical to
  ``ref.quantized_matmul_ref`` and to the reference's oracle;
* the float family within rtol 1e-4 / atol 2e-3 of
  ``ref.ternary_matmul_ref`` (the reference's contract: the LUT identity
  and the gathers sum in other orders than the dense product);
* bf16 activations return bf16: the int8 family bit-identical to the oracle
  through the same casts, the float family within rtol 2e-2 / atol 2e-1.

On the CPU the kernels' plain versions run; the CUDA kernels meet the same
contract in ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_conformance import DENSITIES, KERNEL_CASES, SHAPES, _case

from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.core import bitlinear
from repro_torch.kernels import ref
from repro_torch.plan import registry


def _port_case(shape, density):
    jfz, t, x = _case(shape, density)
    fz = bridge.frozen_from_reference(jfz, device="cpu")
    xn = np.array(x)
    return jfz, fz, torch.from_numpy(np.array(t)), torch.from_numpy(xn), xn


def test_port_registry_has_every_conformance_row():
    assert set(registry.names()) == set(KERNEL_CASES)
    assert registry.SPARSE_KERNELS == ("tsar_sparse", "tsar_sparse_padded")


def test_fixture_carried_across_supports_every_kernel():
    _, fz, _, _, _ = _port_case(SHAPES[0], DENSITIES[1])
    assert registry.available(fz) == registry.names()
    assert set(registry.available(fz)) == set(KERNEL_CASES)


@pytest.mark.conformance
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kernel", sorted(KERNEL_CASES))
def test_port_kernel_conformance(kernel, shape, density):
    jfz, fz, t, x, xn = _port_case(shape, density)
    y = bitlinear.apply_frozen(fz, x, plan=kernel)
    assert y.dtype == torch.float32 and tuple(y.shape) == (shape[0], shape[2])
    if KERNEL_CASES[kernel]["exact"]:
        want = ref.quantized_matmul_ref(x, fz.packed)
        assert torch.equal(y, want)
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(jref.quantized_matmul_ref(jnp.asarray(xn), jfz.packed)))
    else:
        np.testing.assert_allclose(y.numpy(),
                                   ref.ternary_matmul_ref(x, t, fz.packed.scale).numpy(),
                                   rtol=1e-4, atol=2e-3)


@pytest.mark.conformance
@pytest.mark.parametrize("kernel", sorted(KERNEL_CASES))
def test_port_kernel_conformance_bf16(kernel):
    _, fz, t, x, _ = _port_case(SHAPES[0], DENSITIES[1])
    xb = x.to(torch.bfloat16)
    y = bitlinear.apply_frozen(fz, xb, plan=kernel)
    assert y.dtype == torch.bfloat16
    if KERNEL_CASES[kernel]["exact"]:
        want = ref.quantized_matmul_ref(xb, fz.packed).to(torch.bfloat16)
        assert torch.equal(y, want)
    else:
        want = ref.ternary_matmul_ref(xb, t, fz.packed.scale)
        np.testing.assert_allclose(y.to(torch.float32).numpy(), want.numpy(),
                                   rtol=2e-2, atol=2e-1)
