"""The float32 flash kernels' arithmetic on the CPU: each float32 product as
three TF32 products (split TF32, ``ops/flash_attention.py::split_tf32`` and
``tf32x3_matmul``, which mirror ``csrc/flash_attention_tf32.cuh``).

The split rounds like ``cvt.rna.tf32.f32``; the plain versions with every
product taken as ``tf32x3_matmul`` stay within the card's float32 limits of
the float32 plain version and of the JAX kernels in interpret mode; one
TF32 product per float32 product does not, which shows that the split is
needed and that the limits see its absence. tests/test_torch_cuda_flash.py
holds the kernels themselves to the plain version on a card.
"""

import math
import struct
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import FLASH_F32_GRAD_TOL, FLASH_F32_TOL
from composer_tpu.ops.pallas_attention import relative_flash_attention as jax_flash
from composer_tpu_torch.ops import flash_attention as fa


def _f32(x: float) -> float:
    return struct.unpack("<f", struct.pack("<f", x))[0]


def _rna_tf32(x: float) -> float:
    """TF32 rounding of a float32 value by exact arithmetic: to the nearest
    multiple of 2^(e - 10) (e the exponent, at least float32's -126), ties
    away from zero."""
    if x == 0.0:
        return x
    exponent = max(math.frexp(abs(x))[1] - 1, -126)
    ulp = Fraction(2) ** (exponent - 10)
    units, rest = divmod(Fraction(abs(x)), ulp)
    if rest * 2 >= ulp:
        units += 1
    return math.copysign(float(units * ulp), x)


def _split(x: float):
    big, small = fa.split_tf32(torch.tensor([x], dtype=torch.float32))
    return float(big[0]), float(small[0])


SMALLEST_SUBNORMAL = 2.0 ** -149


@pytest.mark.parametrize("x, big, small", [
    (0.0, 0.0, 0.0),
    (1.0, 1.0, 0.0),
    # A tie between 1 and 1 + 2^-10 goes away from zero (half-even would
    # give 1); the small part is the negative remainder.
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -(2.0 ** -11)),
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10), 2.0 ** -11),
    # Just below the tie rounds down; the remainder keeps 11 bits of it.
    (_f32(1.0 + 2.0 ** -11 - 2.0 ** -23), 1.0, _rna_tf32(2.0 ** -11 - 2.0 ** -23)),
    (1.0 + 2.0 ** -11 + 2.0 ** -23, 1.0 + 2.0 ** -10, _rna_tf32(-(2.0 ** -11) + 2.0 ** -23)),
    # The kernels' mask value, a large negative.
    (-1e30, _rna_tf32(_f32(-1e30)), _rna_tf32(_f32(_f32(-1e30) - _rna_tf32(_f32(-1e30))))),
    # Subnormals: TF32 keeps float32's exponent range, so its spacing there
    # is 2^-136 (8192 of the smallest float32 subnormal), and the remainder
    # rounds at the same spacing: below half of it both parts are 0, a tie
    # goes away from zero in each.
    (SMALLEST_SUBNORMAL, 0.0, 0.0),
    (4096 * SMALLEST_SUBNORMAL, 8192 * SMALLEST_SUBNORMAL, -8192 * SMALLEST_SUBNORMAL),
    (-12289 * SMALLEST_SUBNORMAL, -16384 * SMALLEST_SUBNORMAL, 0.0),
    # The largest subnormal rounds up to the smallest normal.
    (_f32(2.0 ** -126 - SMALLEST_SUBNORMAL), 2.0 ** -126, 0.0),
])
def test_split_rounds_like_cvt_rna(x, big, small):
    """``split_tf32`` at hand-picked values: big is ``cvt.rna.tf32.f32(x)``
    (nearest, ties away from zero, 10 mantissa bits), small the same rounding
    of ``x - big``; both agree with the exact-arithmetic rounding."""
    x = _f32(x)
    got_big, got_small = _split(x)
    assert (got_big, got_small) == (big, small)
    assert got_big == _rna_tf32(x)
    assert got_small == _rna_tf32(_f32(x - got_big))


MAGNITUDES = st.floats(min_value=2.0 ** -100, max_value=2.0 ** 127, width=32,
                       exclude_max=True)


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(st.one_of(MAGNITUDES, MAGNITUDES.map(lambda x: -x)))
def test_big_plus_small_recovers_x(x):
    """For float32 from 2^-100 up to 2^127 in magnitude, big and small are
    TF32 values (the low 13 bits clear), big is the exact rounding, and big
    + small is within 2^-21 of |x| of x. (Below about 2^-116 the remainder
    falls among TF32's subnormals, spaced 2^-136, and the bound no longer
    holds; attention's operands are nowhere near there.)"""
    big, small = _split(x)
    assert big == _rna_tf32(x)
    for part in (big, small):
        assert struct.unpack("<I", struct.pack("<f", part))[0] & 0x1FFF == 0
    assert abs(Fraction(x) - Fraction(big) - Fraction(small)) <= Fraction(abs(x)) * Fraction(2) ** -21


def _inputs(use_rel, depth, seed=0, B=1, H=2, S=256, W=512):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((B, H, S, depth)).astype(np.float32) for _ in range(4))
    e = rng.standard_normal((H, W, depth)).astype(np.float32) if use_rel else None
    return q, k, v, e, cot


def _torch(*arrays):
    return [None if a is None else torch.tensor(a) for a in arrays]


def _run(product, q, k, v, e, cot, rate):
    """O, lse and dq, dk, dv (dE) of the plain versions with ``product``;
    the backward starts from the float32 forward's O and lse."""
    kw = dict(scale=True, dropout_rate=rate, dropout_seed=11 if rate else None)
    out, lse = fa.flash_attention_reference(q, k, v, e, product=product, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, e, **kw)
    grads = fa.flash_attention_backward_reference(q, k, v, e, ref_out, ref_lse, cot,
                                                  product=product, **kw)
    return (out, lse), grads


def _one_tf32_matmul(a, b):
    return fa.split_tf32(a)[0] @ fa.split_tf32(b)[0]


@pytest.mark.parametrize("depth", [16, 64, 128])
@pytest.mark.parametrize("use_rel", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_products_keep_the_float32_limits(depth, use_rel, rate):
    """The plain forward and backward with every product as
    ``tf32x3_matmul`` (the kernels' arithmetic) against the float32 plain
    version at B=1, H=2, S=256: O and lse within ``FLASH_F32_TOL``, dq, dk,
    dv and dE within ``FLASH_F32_GRAD_TOL`` of their scale, the card's
    phase-4 limits."""
    q, k, v, e, cot = _torch(*_inputs(use_rel, depth, seed=depth))
    (out, lse), grads = _run(fa.tf32x3_matmul, q, k, v, e, cot, rate)
    (ref_out, ref_lse), ref_grads = _run(torch.matmul, q, k, v, e, cot, rate)
    assert float((out - ref_out).abs().max()) <= FLASH_F32_TOL
    assert float((lse - ref_lse).abs().max()) <= FLASH_F32_TOL
    for name, grad, ref in zip(("dq", "dk", "dv", "dE"), grads, ref_grads):
        if ref is None:
            assert grad is None
            continue
        scale = float(ref.abs().max())
        assert float((grad - ref).abs().max()) <= FLASH_F32_GRAD_TOL * scale, name


@pytest.mark.parametrize("depth", [16, 64, 128])
def test_split_products_match_jax_interpret_mode(depth):
    """One case a head_dim (the band on, dropout 0, whose bits differ between
    the packages): the split-product plain version against the JAX kernels
    in interpret mode within the same limits (O, and dq, dk, dv, dE of their
    scale)."""
    q, k, v, e, cot = _inputs(True, depth, seed=100 + depth)

    def loss(q, k, v, e):
        return jnp.sum(jax_flash(q, k, v, e, scale=True, block=128) * cot)

    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_flash(q, k, v, e, scale=True, block=128))
        expected_grads = [np.asarray(g) for g in jax.grad(loss, (0, 1, 2, 3))(q, k, v, e)]
    tq, tk, tv, te, tcot = _torch(q, k, v, e, cot)
    (out, _), grads = _run(fa.tf32x3_matmul, tq, tk, tv, te, tcot, 0.0)
    assert float(np.abs(out.numpy() - expected).max()) <= FLASH_F32_TOL
    for name, grad, ref in zip(("dq", "dk", "dv", "dE"), grads, expected_grads):
        scale = float(np.abs(ref).max())
        assert float(np.abs(grad.numpy() - ref).max()) <= FLASH_F32_GRAD_TOL * scale, name


@pytest.mark.parametrize("depth", [16, 64, 128])
@pytest.mark.parametrize("use_rel", [False, True])
def test_one_tf32_product_misses_the_float32_limit(depth, use_rel):
    """At the same shapes, one TF32 product per float32 product (big_a
    big_b) puts O more than ``FLASH_F32_TOL`` from the float32 plain version
    (about 1e-3 against 2e-4), while the split stays within it: the split is
    needed, and the limit is sharp enough to see it missing."""
    q, k, v, e, cot = _torch(*_inputs(use_rel, depth, seed=depth))
    (one, _), _ = _run(_one_tf32_matmul, q, k, v, e, cot, 0.0)
    (three, _), _ = _run(fa.tf32x3_matmul, q, k, v, e, cot, 0.0)
    (ref, _), _ = _run(torch.matmul, q, k, v, e, cot, 0.0)
    assert float((one - ref).abs().max()) > 2 * FLASH_F32_TOL
    assert float((three - ref).abs().max()) <= FLASH_F32_TOL / 10
