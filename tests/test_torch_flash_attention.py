"""The port's flash attention (``ops/flash_attention.py``) against the JAX
package's Pallas flash attention in interpret mode, and the port's dropout
on its own (f32 and f64, CPU). On CPU tensors the wrappers run the plain
PyTorch version; tests/test_torch_cuda_flash.py holds the kernels to it on
a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from composer_tpu.ops.pallas_attention import relative_flash_attention as jax_flash
from composer_tpu_torch.ops import attention
from composer_tpu_torch.ops import flash_attention as fa
from composer_tpu_torch.ops.philox import philox4x32_10

# The tolerances of tests/test_pallas_attention.py: f32, different
# summation orders.
OUT_TOL = 2e-4
GRAD_TOL = 5e-4


def _inputs(use_rel, B=1, H=2, S=256, D=16, W=512, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4))
    e = rng.standard_normal((H, W, D)).astype(np.float32) if use_rel else None
    return q, k, v, e, cot


@pytest.mark.parametrize("depth", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("use_rel", [False, True])
def test_flash_matches_jax_interpret_mode(use_rel, depth):
    """Forward and dq/dk/dv/dE against the JAX kernels (block 128: two
    q-tiles, off-diagonal tiles and the in-place dQ/dE accumulation), at the
    default model's head_dim (16), the flagship's (64), the embed-2048
    architecture's (128), 32, and 48, which the port's kernels run padded to
    64 (JAX pads every depth to 128)."""
    q, k, v, e, cot = _inputs(use_rel, D=depth)

    def loss(q, k, v, e):
        return jnp.sum(jax_flash(q, k, v, e, scale=True, block=128) * cot)

    argnums = (0, 1, 2, 3) if use_rel else (0, 1, 2)
    with pltpu.force_tpu_interpret_mode():
        expected = jax_flash(q, k, v, e, scale=True, block=128)
        expected_grads = jax.grad(loss, argnums)(q, k, v, e)

    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v, e) if x is not None]
    out = fa.relative_flash_attention(*leaves[:3], leaves[3] if use_rel else None)
    (out * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected),
                               rtol=OUT_TOL, atol=OUT_TOL)
    for name, leaf, grad in zip(("dq", "dk", "dv", "dE"), leaves, expected_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(grad), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_lse_is_the_row_log_sum_exp():
    q, k, v, e, _ = _inputs(True, S=128, W=128)
    t = [torch.tensor(x) for x in (q, k, v, e)]
    _, lse = fa.flash_attention_forward(*t)
    scores = attention.relative_logits_full(t[0], t[3]) + t[0] @ t[1].transpose(-1, -2)
    scores = scores * 16 ** -0.5
    causal = torch.ones(128, 128, dtype=torch.bool).tril()
    expected = torch.logsumexp(scores.masked_fill(~causal, -torch.inf), dim=-1)
    np.testing.assert_allclose(lse.numpy(), expected.numpy(), rtol=1e-6, atol=1e-5)


def test_dropout_rate_zero_equals_no_dropout():
    q, k, v, e, _ = _inputs(True, S=128, W=128)
    t = [torch.tensor(x) for x in (q, k, v, e)]
    plain = fa.relative_flash_attention(*t)
    zero = fa.relative_flash_attention(*t, dropout_rate=0.0, dropout_seed=7)
    assert torch.equal(plain, zero)
    with pytest.raises(ValueError, match="dropout_seed"):
        fa.relative_flash_attention(*t, dropout_rate=0.1)


def test_gradcheck_with_dropout_uses_the_forward_mask():
    """float64 finite differences of the forward (fixed seed, so a fixed
    mask) against the backward, which regenerates the mask from the seed."""
    rng = np.random.default_rng(1)

    def leaf(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float64, requires_grad=True)

    q, k, v, e = leaf(1, 2, 8, 4), leaf(1, 2, 8, 4), leaf(1, 2, 8, 4), leaf(2, 8, 4)
    mult = fa.dropout_multiplier(11, 0.3, 1, 2, 8, torch.float64)
    assert 0 < int((mult == 0).sum()) < mult.numel()  # the mask drops some weights

    def fn(q, k, v, e):
        return fa.relative_flash_attention(q, k, v, e, dropout_rate=0.3, dropout_seed=11)

    assert torch.autograd.gradcheck(fn, (q, k, v, e), eps=1e-6, atol=1e-6)


def test_keep_fraction_within_binomial_bounds():
    rate, n = 0.1, 4 * 256 * 256
    bits = fa.dropout_bits(123, 4, 256)
    threshold, keep_scale = fa.dropout_constants(rate)
    kept = float((bits >= threshold).double().mean())
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(kept - (1 - rate)) < 5 * sigma, kept
    mult = fa.dropout_multiplier(123, rate, 2, 2, 256)
    values = torch.unique(mult).tolist()
    assert values[0] == 0.0 and values[1] == pytest.approx(keep_scale) and len(values) == 2
    assert not torch.equal(bits, fa.dropout_bits(124, 4, 256))  # the seed matters


def test_philox_mask_is_identical_for_two_tilings():
    """The forward kernel draws one Philox call per 4 keys of a 64 x 64
    tile, the backward one call per element (word ``k & 3``); both give the
    whole-matrix bits, so the mask does not depend on the tiling."""
    seed, bh, seq = 99, 3, 128
    expected = fa.dropout_bits(seed, bh, seq)

    def words(b, rows, cols):
        r, c = torch.meshgrid(rows, cols, indexing="ij")
        out = philox4x32_10(c >> 2, r, torch.full_like(r, b), torch.zeros_like(r), seed)
        return torch.stack(out, dim=-1).gather(-1, (c & 3)[..., None])[..., 0]

    tiled = torch.zeros_like(expected)
    per_element = torch.zeros_like(expected)
    for b in range(bh):
        for i0 in range(0, seq, 64):
            for j0 in range(0, seq, 64):
                rows, cols = torch.arange(i0, i0 + 64), torch.arange(j0, j0 + 64)
                tiled[b, i0:i0 + 64, j0:j0 + 64] = words(b, rows, cols)
        for i0 in range(0, seq, 32):
            rows, cols = torch.arange(i0, i0 + 32), torch.arange(seq)
            per_element[b, i0:i0 + 32] = words(b, rows, cols)
    assert torch.equal(tiled, expected) and torch.equal(per_element, expected)


def test_routing_rule():
    """``use_pallas`` with square causal attention and S % 128 == 0 takes
    the flash path, whatever the head_dim; other shapes the plain path. A
    CUDA tensor on the flash path goes to the kernel (the wrappers'
    decision; no card needed): a head_dim between the built ones is padded
    up to the next, and one above 128 fails the kernel's checks instead of
    taking the plain path."""
    def qk(seq, depth=16):
        x = torch.zeros(1, 2, seq, depth)
        return x, x

    assert attention.takes_flash_path(*qk(256), use_pallas=True)
    assert not attention.takes_flash_path(*qk(256), use_pallas=False)
    assert not attention.takes_flash_path(*qk(100), use_pallas=True)
    assert attention.takes_flash_path(*qk(256, depth=8), use_pallas=True)
    assert attention.takes_flash_path(*qk(256, depth=192), use_pallas=True)
    x8 = qk(256, depth=8)[0]
    with pytest.raises(ValueError, match="head_dim"):
        fa._kernel_args(x8, None, 0.0, None)  # the kernels take only built widths
    padded = fa.pad_head_dim(fa.padded_head_dim(x8.dtype, 8), x8)[0]
    assert fa._kernel_args(padded, None, 0.0, None)[0] == ("tf32x3", 16)
    with pytest.raises(ValueError, match="head_dim 192"):
        fa.padded_head_dim(torch.float32, 192)
    fa._kernel_args(qk(256)[0], None, 0.0, None)  # head_dim 16 passes
    assert not attention.takes_flash_path(*qk(256), use_pallas=True, mask=torch.ones(256, 256))
    assert not attention.takes_flash_path(*qk(256), use_pallas=True, q_position=3)
    assert fa.runs_kernel(torch.device("cuda")) and fa.runs_kernel("cuda:0")
    assert not fa.runs_kernel(torch.device("cpu"))


def test_kernel_variant_table():
    """The fixed routing table: bf16 takes the bf16 tensor-core kernels and
    float32 the split-TF32 ones, each built at head_dim 16, 32, 64 and 128;
    other head_dims up to 128 pad to the next built one (8 to 16, 48 to 64,
    96 to 128); float16, float64 and head_dim above 128 raise naming what is
    built and the ROADMAP item."""
    for depth in (16, 32, 64, 128):
        assert fa.kernel_variant(torch.bfloat16, depth) == "mma"
        assert fa.kernel_variant(torch.float32, depth) == "tf32x3"
        for dtype in (torch.bfloat16, torch.float32):
            assert fa.padded_head_dim(dtype, depth) == depth
    for depth, width in ((1, 16), (8, 16), (17, 32), (24, 32), (48, 64), (96, 128),
                         (127, 128)):
        assert fa.padded_head_dim(torch.bfloat16, depth) == width
        assert fa.padded_head_dim(torch.float32, depth) == width
    for dtype, depth in ((torch.bfloat16, 8), (torch.float32, 48), (torch.bfloat16, 192)):
        with pytest.raises(ValueError, match="built for bfloat16, float32 at head_dim "
                                             "16, 32, 64, 128.*Queue 2 item 1b"):
            fa.kernel_variant(dtype, depth)
    for dtype, depth in ((torch.float16, 16), (torch.float16, 64), (torch.float64, 16),
                         (torch.bfloat16, 192), (torch.float32, 129)):
        with pytest.raises(ValueError, match="Queue 2 item 1b"):
            fa.padded_head_dim(dtype, depth)
    x = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16)
    assert fa._kernel_args(x, None, 0.0, None)[0] == ("mma", 64)
    assert fa._kernel_args(x.float(), None, 0.0, None)[0] == ("tf32x3", 64)
    with pytest.raises(ValueError, match="float16 x head_dim 64"):
        fa._kernel_args(x.half(), None, 0.0, None)
    assert set(fa.VARIANTS) == {(route, depth) for route in ("mma", "tf32x3")
                                for depth in (16, 32, 64, 128)}
    assert set(fa.flash_attention_forward.launches) == set(fa.VARIANTS)
    assert set(fa.flash_attention_backward.launches) == set(fa.VARIANTS)


@pytest.mark.parametrize("depth", [8, 24, 48, 96])
@pytest.mark.parametrize("use_rel", [False, True])
def test_padding_gives_the_unpadded_result(use_rel, depth):
    """What the wrappers do on a card for a head_dim between the built
    ones, on the CPU: pad q, k, v, E and the cotangent to the built width,
    run the plain version there with the true depth's scale, slice back.
    O, lse and dq/dk/dv/dE equal the plain version at the true width
    (float32, different summation orders), with dropout on."""
    q, k, v, e, cot = (None if x is None else torch.tensor(x)
                       for x in _inputs(use_rel, S=128, D=depth, W=256, seed=depth))
    kw = dict(dropout_rate=0.1, dropout_seed=5)
    width = fa.padded_head_dim(torch.float32, depth)
    assert width in fa.BUILT_HEAD_DIMS and width > depth
    qp, kp, vp, ep, cotp = fa.pad_head_dim(width, q, k, v, e, cot)
    assert qp.shape[-1] == width and (ep is None) == (not use_rel)
    c = depth ** -0.5
    out, lse = fa.flash_attention_reference(q, k, v, e, **kw)
    out_p, lse_p = fa.flash_attention_reference(qp, kp, vp, ep, scale=c, **kw)
    assert float(out_p[..., depth:].abs().max()) == 0.0
    np.testing.assert_allclose(out_p[..., :depth].numpy(), out.numpy(), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), rtol=OUT_TOL, atol=OUT_TOL)
    grads = fa.flash_attention_backward_reference(q, k, v, e, out, lse, cot, **kw)
    grads_p = fa.flash_attention_backward_reference(qp, kp, vp, ep, out_p, lse_p, cotp,
                                                    scale=c, **kw)
    for name, grad, grad_p in zip(("dq", "dk", "dv", "dE"), grads, grads_p):
        if grad is None:
            assert grad_p is None
            continue
        np.testing.assert_allclose(grad_p[..., :depth].numpy(), grad.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("seq", [100, 128])
def test_flash_path_equals_plain_path(seq):
    """With S % 128 != 0 ``use_pallas`` is the plain path itself; at
    S = 128 the flash path (-1e30 masking) equals it (-1e4 masking): both
    give masked keys probability 0."""
    q, k, v, e, _ = _inputs(True, S=seq, W=128)
    t = [torch.tensor(x) for x in (q, k, v, e)]
    plain = attention.multihead_attention(*t[:3], rel_embedding=t[3])
    routed = attention.multihead_attention(*t[:3], rel_embedding=t[3], use_pallas=True)
    np.testing.assert_allclose(routed.numpy(), plain.numpy(), rtol=1e-5, atol=1e-6)


def test_plain_dropout_path_is_inverted_dropout():
    q, k, v, _, _ = _inputs(False, S=100, W=128)
    t = [torch.tensor(x) for x in (q, k, v)]
    ones = torch.ones_like(t[2])
    out = attention.multihead_attention(t[0], t[1], ones, dropout_rate=0.5,
                                        dropout_generator=torch.Generator().manual_seed(0))
    # Each output is the sum of the kept weights / (1 - rate): a row of
    # weights that sum to 1 keeps about half of them, times 2.
    assert abs(float(out.mean()) - 1.0) < 0.1 and float(out.std()) > 0.05


def test_window_check():
    q, k, v, e, _ = _inputs(True, S=256, W=128)
    with pytest.raises(ValueError, match="exceeds relative window"):
        fa.relative_flash_attention(*(torch.tensor(x) for x in (q, k, v, e)))
