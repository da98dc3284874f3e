"""The bound and the model FLOPs against hand values."""
import math

import pytest

from h100bench import roofline, spec, weights

BITNET = spec.config(spec.load_benchmark(), "bitnet-2b-4t")
# deepseek-coder-33b's published sizes, a second shape for the arithmetic.
CODER = {"hidden_size": 7168, "intermediate_size": 19200, "num_hidden_layers": 62,
         "num_attention_heads": 56, "num_key_value_heads": 8, "head_dim": 128,
         "vocab_size": 32256, "rope_theta": 100000.0, "rms_norm_eps": 1e-6}


def test_bitnet_four_row_step_bound_is_0_160_ms():
    # One N = 4 decode step's 210 tsar_matmul calls: bytes-bound, 0.160 ms.
    assert roofline.step_bound_s(BITNET, 4) * 1e3 == pytest.approx(0.160, abs=0.0005)


def test_coder_step_bound_at_n4():
    assert roofline.step_bound_s(CODER, 4) * 1e3 == pytest.approx(2.48, abs=0.01)


def test_bound_turns_to_operations_at_wide_n():
    k, m = 7168, 19200
    n = 524
    assert roofline.bound_s(n, k, m) == pytest.approx(2 * n * k * m / 1.979e15)
    n = 1
    nbytes = k * m / 4 + k + 4 + 4 * m + 4 * m
    assert roofline.bound_s(n, k, m) == pytest.approx(nbytes / 3.35e12)


def test_projection_weights():
    per = sum(k * m for _, k, m in weights.projections(BITNET))
    assert per == 2560 * (2560 + 640 + 640 + 2560) + 3 * 2560 * 6912
    per = sum(k * m for _, k, m in weights.projections(CODER))
    assert per == 7168 * (7168 + 1024 + 1024 + 7168) + 3 * 7168 * 19200


def test_flops_by_hand():
    # One decode token at context 1000, emitted: bitnet.
    proj = 2560 * (2560 + 640 + 640 + 2560) + 3 * 2560 * 6912
    want = 30 * (2 * proj + 4 * 1000 * 20 * 128) + 2 * 2560 * 128256
    assert roofline.flops(BITNET, 1, 1000, 1) == want
    # A 512-row chunk starting at position 256, nothing emitted.
    ctx = sum(p + 1 for p in range(256, 768))
    assert roofline.flops(BITNET, 512, ctx, 0) == 30 * (2 * proj * 512 + 4 * ctx * 20 * 128)
    assert math.isclose(roofline.flops(CODER, 0, 0, 3), 3 * 2 * 7168 * 32256)
