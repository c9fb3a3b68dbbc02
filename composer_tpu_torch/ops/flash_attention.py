"""Causal flash attention with the Music-Transformer relative bias and
attention dropout, forward and backward.

Port of ``composer_tpu/ops/pallas_attention.py``. The TPU kernels
``_flash_kernel`` (forward) and ``_flash_bwd_kernel`` (merged backward) are
replaced by the Hopper kernels of ``csrc/flash_attention.cu``; the file's
header states what they compute and how. ``relative_flash_attention`` keeps
the JAX signature and the ``[B, H, S, D]`` layout.

Two routes, one fixed table (``kernel_variant``), each built at head_dim
16, 32, 64 and 128 (``BUILT_HEAD_DIMS``), both on the tensor cores: bf16
(``"mma"``) takes ``csrc/flash_attention_mma.cuh``, the training path's
type; float32 (``"tf32x3"``) takes ``csrc/flash_attention_tf32.cuh``, which
forms every float32 product as three TF32 products (split TF32), the route
of the float32 parity tests and of float32 training. Any other head_dim up
to 128 is zero-padded to the next built one (``padded_head_dim``,
``pad_head_dim``), as the JAX wrapper pads the depth to 128 lanes, with the
softmax scale of the true depth. float16, float64 and head_dim above 128
raise (ROADMAP Queue 2 item 1b).

Beside the kernels, in this module:

* ``flash_attention_reference`` / ``flash_attention_backward_reference``:
  the plain PyTorch version of each direction. They take the same dropout
  bits (``dropout_multiplier``) and mask with the kernel's -1e30, so the
  kernel and its plain version agree to summation order. ``product``
  replaces every matrix product (tests pass ``tf32x3_matmul``).
* ``split_tf32`` / ``tf32x3_matmul``: the float32 kernels' arithmetic on
  the CPU, for the tests only: the TF32 rounding of ``cvt.rna.tf32.f32``
  and the three-product sum in the kernels' order.
* ``flash_attention_forward`` / ``flash_attention_backward``: the wrappers.
  A CPU tensor runs the plain version; a CUDA tensor launches the kernel
  (counted by ``(route, built head_dim)`` in
  ``flash_attention_forward.launches`` and
  ``flash_attention_backward.launches``) or raises.

What the JAX module does for Mosaic and the port does not: padding every
head_dim to 128 lanes (the port pads only to the next built width), the
block-size policy, the per-row scalars padded to 8 sublanes, the lane
shears. The TPU's dropout bits (``pltpu.prng_random_bits``
keyed by tile) cannot be replayed; the port keys Philox4x32-10 by element.
"""

from __future__ import annotations

import ctypes

import torch

from composer_tpu_torch.ops.attention import skew_relative_logits
from composer_tpu_torch.ops.philox import philox4x32_10

NEG_INF = -1e30
KERNEL_BLOCK = 64  # rows per tile in the kernels; S must be a multiple
# The head_dims each route is built for; the wrappers pad any other up to
# the next of them.
BUILT_HEAD_DIMS = (16, 32, 64, 128)
# dtype -> route: "mma" the bf16 tensor-core pair, "tf32x3" the float32 one
# (each float32 product as three TF32 products).
ROUTES = {torch.bfloat16: "mma", torch.float32: "tf32x3"}
DTYPES = {route: dtype for dtype, route in ROUTES.items()}
# (dtype, head_dim) -> the kernels built for it.
KERNEL_VARIANTS = {(dtype, depth): route for dtype, route in ROUTES.items()
                   for depth in BUILT_HEAD_DIMS}
UNBUILT = "ROADMAP Queue 2 item 1b (flash kernels in float16, float64 and at head_dim > 128)"


def kernel_variant(dtype, depth: int) -> str:
    """The route (``"mma"`` or ``"tf32x3"``) of the kernels built for
    ``dtype`` at ``depth``; ``ValueError`` naming what is built for anything
    else (a head_dim between the built ones goes through
    ``padded_head_dim`` first)."""
    route = KERNEL_VARIANTS.get((dtype, depth))
    if route is None:
        built = ", ".join(str(d)[6:] for d in ROUTES)
        raise ValueError(f"the flash kernels are built for {built} at head_dim "
                         f"{', '.join(map(str, BUILT_HEAD_DIMS))}, not {str(dtype)[6:]} x "
                         f"head_dim {depth}: {UNBUILT}")
    return route


def padded_head_dim(dtype, depth: int) -> int:
    """The built head_dim the kernels run ``depth`` at: the smallest of
    ``BUILT_HEAD_DIMS`` not below it. ``ValueError`` for a dtype without
    kernels or a depth above 128."""
    width = next((d for d in BUILT_HEAD_DIMS if d >= depth), None)
    if dtype not in ROUTES or width is None or depth < 1:
        kernel_variant(dtype, depth)  # raises, naming what is built
    return width


def pad_head_dim(width: int, *tensors):
    """Each tensor (None passes through) zero-padded on its last axis to
    ``width``. Zero columns of q, k and E add nothing to a score, and zero
    columns of v give zero output columns, so the padded call's outputs
    sliced back to the true depth are the unpadded call's, given the true
    depth's softmax scale."""
    return tuple(t if t is None or t.shape[-1] == width
                 else torch.nn.functional.pad(t, (0, width - t.shape[-1])).contiguous()
                 for t in tensors)


# The keys of the wrappers' launch counts: (route, head_dim) of each kernel built.
VARIANTS = tuple((route, depth) for (_, depth), route in KERNEL_VARIANTS.items())


def runs_kernel(device) -> bool:
    """The wrappers' decision: a CUDA tensor goes to the kernel, a CPU tensor
    to the plain version."""
    return torch.device(device).type == "cuda"


def dropout_constants(rate: float):
    """``(threshold, keep_scale)``: keep an element when its 32-bit word is
    ``>= threshold``, then multiply by ``keep_scale`` (``_dropout_scaler``)."""
    threshold = min(int(rate * 4294967296.0), 4294967295)
    return threshold, 1.0 / (1.0 - rate)


def dropout_bits(seed: int, bh: int, seq: int, device=None) -> torch.Tensor:
    """``[bh, seq, seq]`` uint32 words (in int64) of the attention dropout.

    Element (b, i, j) is word ``j % 4`` of Philox4x32-10 with counter
    ``(j // 4, i, b, 0)`` and key ``(seed, 0)``: one word per element, so
    the mask does not depend on how a kernel tiles the matrix.
    """
    groups = seq // 4
    shape = (bh, seq, groups)
    c0 = torch.arange(groups, dtype=torch.int64, device=device).expand(shape)
    c1 = torch.arange(seq, dtype=torch.int64, device=device)[:, None].expand(shape)
    c2 = torch.arange(bh, dtype=torch.int64, device=device)[:, None, None].expand(shape)
    c3 = torch.zeros(shape, dtype=torch.int64, device=device)
    words = philox4x32_10(c0, c1, c2, c3, seed)
    return torch.stack(words, dim=-1).reshape(bh, seq, seq)


def dropout_multiplier(seed: int, rate: float, batch: int, heads: int, seq: int,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """``[B, H, S, S]``: ``1/(1-rate)`` where an element is kept, else 0."""
    threshold, keep_scale = dropout_constants(rate)
    bits = dropout_bits(seed, batch * heads, seq, device)
    keep = (bits >= threshold).reshape(batch, heads, seq, seq)
    return keep.to(dtype) * keep_scale


def split_tf32(x: torch.Tensor):
    """``(big, small)`` of float32 ``x`` as the float32 kernels split an
    operand: ``big`` is x rounded to TF32 like ``cvt.rna.tf32.f32`` (to
    nearest, ties away from zero, 10 mantissa bits: ``(bits + 0x1000) &
    ~0x1FFF``), ``small`` the same rounding of ``x - big``."""
    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    big = tf32(x)
    return big, tf32(x - big)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the float32 kernels form it: three TF32 products, summed
    in float32 smallest first (``big_a small_b + small_a big_b + big_a
    big_b``); ``small_a small_b`` is dropped."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    return (a_big @ b_small + a_small @ b_big) + a_big @ b_big


def _seed_int(seed) -> int:
    return int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)


def softmax_scale(scale, depth: int) -> float:
    """The factor on the scores: a float as given (the padded kernels' call,
    whose scale is that of the true depth); otherwise ``depth ** -0.5`` where
    ``scale`` is true, 1 where it is false."""
    if isinstance(scale, float):
        return scale
    return depth ** -0.5 if scale else 1.0


def _band(rel_embedding, seq: int, dtype, compute):
    """The table's rows of distances ``seq - 1 .. 0``, ``[H, seq, D]``."""
    _check_window(seq, rel_embedding)
    return rel_embedding.to(dtype).to(compute)[:, rel_embedding.shape[1] - seq:]


def _scores(q, k, rel_embedding, scale, product=torch.matmul):
    """Scaled, causally masked scores ``[B, H, S, S]`` in the compute type
    (float32 for float32 and bf16 inputs, float64 for float64)."""
    compute = torch.promote_types(q.dtype, torch.float32)
    qf, kf = q.to(compute), k.to(compute)
    scores = product(qf, kf.transpose(-1, -2))
    if rel_embedding is not None:
        band = _band(rel_embedding, q.shape[2], q.dtype, compute)
        scores = scores + skew_relative_logits(product(qf, band.transpose(-1, -2)))
    factor = softmax_scale(scale, q.shape[-1])
    if factor != 1.0:
        scores = scores * factor
    seq = q.shape[2]
    causal = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    return scores.masked_fill(~causal, NEG_INF)


def _check_window(seq: int, rel_embedding):
    if rel_embedding is not None and seq > rel_embedding.shape[1]:
        raise ValueError(f"sequence {seq} exceeds relative window {rel_embedding.shape[1]}")


def flash_attention_reference(q, k, v, rel_embedding=None, *, scale=True,
                              dropout_rate: float = 0.0, dropout_seed=None,
                              product=torch.matmul):
    """Plain version of the forward kernel: ``(out, lse)``. ``scale``: True,
    False or the factor itself (``softmax_scale``); ``product`` forms every
    matrix product.

    ``out`` is ``[B, H, S, D]`` in q's dtype, ``lse`` the ``[B, H, S]``
    log-sum-exp of each row's scores in the compute type. Dropout multiplies
    the normalised probabilities by ``dropout_multiplier``.
    """
    _check_window(q.shape[2], rel_embedding)
    scores = _scores(q, k, rel_embedding, scale, product)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    if dropout_rate > 0.0:
        batch, heads, seq, _ = q.shape
        p = p * dropout_multiplier(_seed_int(dropout_seed), dropout_rate, batch, heads,
                                   seq, p.dtype, q.device)
    out = product(p, v.to(p.dtype))
    return out.to(q.dtype), lse


def flash_attention_backward_reference(q, k, v, rel_embedding, out, lse, dout, *,
                                       scale=True, dropout_rate: float = 0.0,
                                       dropout_seed=None, product=torch.matmul):
    """Plain version of the backward kernel: ``(dq, dk, dv, dE)`` (dE is None
    without the relative table), from the forward's ``out`` and ``lse``;
    ``product`` forms every matrix product.

    With ``P = exp(scores - lse)``, dropout multiplier ``M`` and
    ``delta = rowsum(dout * out)``: ``ds = P * (M * dout v^T - delta)``,
    ``dv = (P M)^T dout``, ``dq = c ds k``, ``dk = c ds^T q`` and, for the
    band, ``dq += c sum_j ds_ij E_(i-j)``, ``dE_d = c sum_(i-j=d) ds_ij q_i``
    (c the softmax scale).
    """
    batch, heads, seq, depth = q.shape
    scores = _scores(q, k, rel_embedding, scale, product)
    compute = scores.dtype
    qf, kf, vf, dof = (t.to(compute) for t in (q, k, v, dout))
    p = torch.exp(scores - lse.to(compute)[..., None])
    delta = (dof * out.to(compute)).sum(-1)
    dp = product(dof, vf.transpose(-1, -2))
    p_dv = p
    if dropout_rate > 0.0:
        mult = dropout_multiplier(_seed_int(dropout_seed), dropout_rate, batch, heads, seq,
                                  compute, q.device)
        dp = dp * mult
        p_dv = p * mult
    ds = p * (dp - delta[..., None])
    c = softmax_scale(scale, depth)
    dv = product(p_dv.transpose(-1, -2), dof)
    dq = c * product(ds, kf)
    dk = c * product(ds.transpose(-1, -2), qf)
    de = None
    if rel_embedding is not None:
        window = rel_embedding.shape[1]
        e_slice = _band(rel_embedding, seq, q.dtype, compute)  # distances S-1..0
        # band[i, m] = ds[i, j] with j = i - (S-1-m): the skew run backwards.
        rows = torch.arange(seq, device=q.device)[:, None]
        cols = torch.arange(seq, device=q.device)[None, :]
        j = cols - (seq - 1) + rows
        band = torch.gather(ds, -1, j.clamp(min=0).expand(batch, heads, seq, seq))
        band = band * (j >= 0).to(compute)
        dq = dq + c * product(band, e_slice)
        de = torch.zeros(rel_embedding.shape, dtype=compute, device=q.device)
        de[:, window - seq:] = c * product(band.transpose(-1, -2), qf).sum(0)
        de = de.to(q.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), de


def _kernel_args(q, rel_embedding, dropout_rate: float, dropout_seed):
    """Checks what the kernel takes (``q`` already padded to a built
    head_dim); returns ``(variant, use_rel, seed tensor, threshold,
    keep_scale, dropout flag)``."""
    batch, heads, seq, depth = q.shape
    variant = (kernel_variant(q.dtype, depth), depth)
    if seq % KERNEL_BLOCK:
        raise ValueError(f"sequence {seq} is not a multiple of {KERNEL_BLOCK}")
    if batch * heads > 65535:
        raise ValueError(f"batch x heads {batch * heads} exceeds the grid's 65535")
    _check_window(seq, rel_embedding)
    seed = torch.zeros(1, dtype=torch.int32, device=q.device)
    threshold, keep_scale = 0, 1.0
    if dropout_rate > 0.0:
        seed = torch.as_tensor(dropout_seed, dtype=torch.int32).reshape(1).to(q.device)
        threshold, keep_scale = dropout_constants(dropout_rate)
    return variant, rel_embedding is not None, seed, threshold, keep_scale, dropout_rate > 0.0


def _check_tensors(*tensors):
    first = tensors[0]
    for t in tensors:
        if t is None:
            continue
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError("flash kernel operands must share one device and dtype")
        if not t.is_contiguous():
            raise ValueError("flash kernel operands must be contiguous")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def flash_attention_forward(q, k, v, rel_embedding=None, *, scale=True,
                            dropout_rate: float = 0.0, dropout_seed=None):
    """``(out, lse)`` of the forward kernel on CUDA tensors, of
    ``flash_attention_reference`` on CPU tensors. ``rel_embedding`` must
    already be in q's dtype for the kernel."""
    if not runs_kernel(q.device):
        return flash_attention_reference(q, k, v, rel_embedding, scale=scale,
                                         dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    from composer_tpu_torch.ops._build import load_library

    _check_tensors(q, k, v, rel_embedding)
    batch, heads, seq, depth = q.shape
    width = padded_head_dim(q.dtype, depth)
    qp, kp, vp, ep = pad_head_dim(width, q, k, v, rel_embedding)
    variant, use_rel, seed, threshold, keep_scale, dropout = _kernel_args(
        qp, ep, dropout_rate, dropout_seed)
    out = torch.empty_like(qp)
    lse = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)
    err = load_library("flash_attention").flash_attention_forward(
        int(variant[0] == "mma"), q.device.index or 0, _ptr(qp), _ptr(kp), _ptr(vp),
        _ptr(ep), _ptr(out), _ptr(lse), _ptr(seed), batch * heads, heads, seq, width,
        ep.shape[1] if use_rel else 0, int(use_rel), softmax_scale(scale, depth), threshold,
        keep_scale, int(dropout), ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_forward failed to launch: cudaError {err}")
    flash_attention_forward.launches[variant] += 1
    return (out if width == depth else out[..., :depth].contiguous()), lse


flash_attention_forward.launches = dict.fromkeys(VARIANTS, 0)


def flash_attention_backward(q, k, v, rel_embedding, out, lse, dout, *, scale=True,
                             dropout_rate: float = 0.0, dropout_seed=None):
    """``(dq, dk, dv, dE)`` of the backward kernel on CUDA tensors, of
    ``flash_attention_backward_reference`` on CPU tensors."""
    if not runs_kernel(q.device):
        return flash_attention_backward_reference(
            q, k, v, rel_embedding, out, lse, dout, scale=scale,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    from composer_tpu_torch.ops._build import load_library

    _check_tensors(q, k, v, rel_embedding, out, dout)
    batch, heads, seq, depth = q.shape
    width = padded_head_dim(q.dtype, depth)
    qp, kp, vp, ep, dop = pad_head_dim(width, q, k, v, rel_embedding, dout)
    variant, use_rel, seed, threshold, keep_scale, dropout = _kernel_args(
        qp, ep, dropout_rate, dropout_seed)
    lse = lse.to(torch.float32).contiguous()
    # delta = rowsum(dO * O) in float32 before the kernel, as _flash_bwd_rule.
    delta = (dout.float() * out.float()).sum(-1)
    dq = torch.zeros(qp.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    de = torch.zeros(ep.shape, dtype=torch.float32, device=q.device) if use_rel else None
    err = load_library("flash_attention").flash_attention_backward(
        int(variant[0] == "mma"), q.device.index or 0, _ptr(qp), _ptr(kp), _ptr(vp),
        _ptr(ep), _ptr(dop), _ptr(lse), _ptr(delta), _ptr(seed), _ptr(dq),
        _ptr(dk), _ptr(dv), _ptr(de), batch * heads, heads, seq, width,
        ep.shape[1] if use_rel else 0, int(use_rel), softmax_scale(scale, depth), threshold,
        keep_scale, int(dropout), ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_backward failed to launch: cudaError {err}")
    flash_attention_backward.launches[variant] += 1
    grads = (dq.to(q.dtype), dk, dv, de.to(rel_embedding.dtype) if use_rel else None)
    if width != depth:
        grads = tuple(g if g is None else g[..., :depth].contiguous() for g in grads)
    return grads


flash_attention_backward.launches = dict.fromkeys(VARIANTS, 0)


class _FlashAttention(torch.autograd.Function):
    """Forward returns ``(out, lse)``; the backward kernel gives dq, dk, dv
    and dE from the saved output and lse (lse is not differentiable)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_embedding, scale, dropout_rate, dropout_seed):
        out, lse = flash_attention_forward(q, k, v, rel_embedding, scale=scale,
                                           dropout_rate=dropout_rate,
                                           dropout_seed=dropout_seed)
        ctx.save_for_backward(q, k, v, rel_embedding, out, lse)
        ctx.options = (scale, dropout_rate, dropout_seed)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, rel_embedding, out, lse = ctx.saved_tensors
        scale, dropout_rate, dropout_seed = ctx.options
        dq, dk, dv, de = flash_attention_backward(
            q, k, v, rel_embedding, out, lse, dout.contiguous(), scale=scale,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed)
        return dq, dk, dv, de, None, None, None


def relative_flash_attention(q, k, v, rel_embedding=None, *, scale=True,
                             dropout_rate: float = 0.0, dropout_seed=None):
    """Causal flash attention. q, k, v: ``[batch, heads, S, D]``.

    ``rel_embedding``: ``[heads, window, D]`` in skew layout (``E[h,
    window-1-d]`` holds distance d), or None; with it, S must not exceed the
    window. It is cast to q's dtype for the kernel, and its gradient comes
    back through the cast. Differentiable in q, k, v and the table.

    ``dropout_rate`` / ``dropout_seed``: attention dropout inside the kernel.
    The seed is an int or a one-element int32 tensor (on the device, so that
    drawing it needs no host synchronisation); the backward regenerates the
    forward's mask from it.
    """
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    _check_window(q.shape[2], rel_embedding)
    if rel_embedding is not None:
        rel_embedding = rel_embedding.to(q.dtype).contiguous()
    out, _ = _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                   rel_embedding, scale, float(dropout_rate), dropout_seed)
    return out


def shard_seed(dropout_seed, mesh):
    """The dropout seed of this rank's shard, folded in as the JAX package
    folds it under ``shard_map``: ``shard = data_index * model +
    model_index``, ``seed + shard * 1000003`` with int32 wrap-around. A
    tensor seed stays on its device."""
    shard = mesh.data_index * mesh.model + mesh.model_index
    if not torch.is_tensor(dropout_seed):
        return (int(dropout_seed) + shard * 1000003 + 2**31) % 2**32 - 2**31
    folded = dropout_seed.to(torch.int64) + shard * 1000003
    return ((folded + 2**31) % 2**32 - 2**31).to(torch.int32)


def sharded_relative_flash_attention(q, k, v, rel_embedding=None, *, mesh, scale=True,
                                     dropout_rate: float = 0.0, dropout_seed=None):
    """Flash attention on this rank's block of a ``(data, model)`` mesh:
    port of ``pallas_attention.sharded_relative_flash_attention``.

    JAX runs the kernel per shard under ``shard_map``; here each rank
    already holds its block, ``[batch / data, heads / model, S, D]``, and
    ``rel_embedding`` its ``heads / model`` rows of the table (the batch is
    cut where a rank takes its rows, ``parallel/mesh.py::local_rows``, and
    the heads where the model is built, ``models/transformer.py``; each
    raises with JAX's message when the cut does not divide). Attention needs
    no collective: this calls ``relative_flash_attention``, the Hopper
    kernels on a CUDA tensor and their plain version on a CPU tensor.

    Dropout folds the shard into the seed (``shard_seed``), so masks differ
    between ranks. The table's gradient ``dE`` stays rank-local: JAX sums it
    over the data axis inside ``shard_map``'s transpose, the port leaves
    that sum to the trainer's one data-group gradient ``all_reduce``, which
    covers ``rel_embedding`` like every other parameter (summing it here as
    well would count it twice).
    """
    if rel_embedding is not None and rel_embedding.shape[0] != q.shape[1]:
        raise ValueError(f"the relative table has {rel_embedding.shape[0]} heads and this "
                         f"rank's block {q.shape[1]}")
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        dropout_seed = shard_seed(dropout_seed, mesh)
    return relative_flash_attention(q, k, v, rel_embedding, scale=scale,
                                    dropout_rate=dropout_rate, dropout_seed=dropout_seed)
