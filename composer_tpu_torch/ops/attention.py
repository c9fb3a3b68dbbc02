"""Multi-head causal attention with Music-Transformer relative position bias.

Port of ``composer_tpu/ops/attention.py``. ``multihead_attention`` keeps the
JAX routing gate (``ops/attention.py:137-182``): with ``use_pallas`` and
square causal self-attention whose length is a multiple of ``MIN_BLOCK``,
attention goes through ``ops/flash_attention.py`` (the Hopper kernels on a
CUDA tensor, their plain version on a CPU tensor). Every other shape takes
the plain path below, as
the JAX package sends it to its band or XLA paths; those compute the same
function and are not ported. Under a mesh of more than one rank
(``flash_mesh``), the flash path is ``sharded_relative_flash_attention`` on
this rank's block.

Layout convention: ``E[h, window-1-d]`` holds the embedding for relative
distance ``d`` (0 = the query position itself, increasing into the past).
Scores combine as ``w * m - 1e4 * (1 - m)`` after scaling, and the relative
bias is added before scaling (reference order). The flash path masks with
-1e30 instead; both give masked keys a probability of exactly 0.
"""

from __future__ import annotations

import torch

# Flash tile edge of the JAX gate (pallas_attention.MIN_BLOCK).
MIN_BLOCK = 128


def causal_mask(q_len: int, k_len: int, q_offset: int = 0, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """[q_len, k_len] mask: 1 where key j may attend from query i, else 0.

    Query i sits at absolute position ``q_offset + i``; key j at position j.
    """
    rows = torch.arange(q_len, device=device)[:, None]
    cols = torch.arange(k_len, device=device)[None, :]
    return (rows + q_offset >= cols).to(dtype)


def skew_relative_logits(rel: torch.Tensor) -> torch.Tensor:
    """The Music-Transformer pad-reshape-slice skew.

    ``rel[..., i, m]`` holds ``q_i . E_slice[m]`` where ``E_slice[m]`` is the
    embedding for distance ``S - 1 - m``; the result aligns it so that
    ``out[..., i, j] = q_i . E(distance i - j)`` (entries j > i are garbage
    and must be masked).
    """
    *batch, s_q, s_k = rel.shape
    padded = torch.nn.functional.pad(rel, (1, 0))
    return padded.reshape(*batch, s_k + 1, s_q)[..., 1:, :]


def relative_logits_full(q: torch.Tensor, rel_embedding: torch.Tensor) -> torch.Tensor:
    """Relative logits for square self-attention.

    q: [B, H, S, D]; rel_embedding: [H, W, D] in skew layout, S <= W.
    Returns [B, H, S, S].
    """
    seq = q.shape[2]
    window = rel_embedding.shape[1]
    if seq > window:
        raise ValueError(f"sequence ({seq}) exceeds the relative window ({window})")
    e_slice = rel_embedding[:, window - seq:]  # distances seq-1 .. 0
    return skew_relative_logits(torch.einsum("bhsd,hmd->bhsm", q, e_slice))


def relative_logits_decode(q: torch.Tensor, rel_embedding: torch.Tensor,
                           position: int, cache_len: int) -> torch.Tensor:
    """Relative logits for one query token against a KV cache.

    q: [B, H, 1, D]. Slot j gets ``q . E(distance position - j)``. E is
    zero-padded on both sides, so distances outside [0, W) give zero bias
    (slots j > position are garbage and must be masked by the caller).
    """
    heads, window, depth = rel_embedding.shape
    padded = torch.nn.functional.pad(rel_embedding, (0, 0, cache_len, cache_len))
    start = cache_len + window - 1 - int(position)
    e_slice = padded[:, start:start + cache_len]
    return torch.einsum("bhqd,hmd->bhqm", q, e_slice)


def takes_flash_path(q, k, *, q_position=None, mask=None, use_pallas: bool = False) -> bool:
    """The routing rule: flash attention for square causal self-attention
    with ``S % MIN_BLOCK == 0``. It does not look at head_dim or dtype: on a
    CUDA tensor the wrapper pads a head_dim up to 128 to the next built one
    and raises for float16, float64 and head_dim above 128."""
    s_q, s_k = q.shape[2], k.shape[2]
    return (use_pallas and s_q == s_k and q_position is None and mask is None
            and s_q % MIN_BLOCK == 0)


def multihead_attention(q, k, v, *, rel_embedding=None, q_position=None,
                        scale: bool = True, mask=None, dropout_generator=None,
                        dropout_rate: float = 0.0, use_pallas: bool = False,
                        flash_mesh=None) -> torch.Tensor:
    """Causal multi-head attention core.

    q: [B, H, S_q, D]; k, v: [B, H, S_k, D]. ``mask`` is [S_q, S_k] with
    1 = attend. ``q_position`` (an int) selects the decode path for S_q == 1
    against a longer cache. ``dropout_rate`` > 0 drops attention weights
    (inverted dropout) with random numbers from ``dropout_generator``.
    ``use_pallas`` routes by ``takes_flash_path``; the flash path draws one
    seed from the generator and keeps its dropout inside the kernel.
    ``flash_mesh``: the ``parallel/mesh.py`` mesh whose block of the batch
    and heads q, k and v are; with more than one rank the flash path folds
    the rank's shard into its dropout seed (JAX's ``shard_map`` gate).
    """
    s_q, s_k = q.shape[2], k.shape[2]
    compute_dtype = q.dtype

    if takes_flash_path(q, k, q_position=q_position, mask=mask, use_pallas=use_pallas):
        from composer_tpu_torch.ops.flash_attention import (
            relative_flash_attention,
            sharded_relative_flash_attention,
        )

        seed = None
        if dropout_rate > 0.0:
            # One int32 seed per call (the JAX gate's randint), drawn on the
            # device so that drawing it does not wait for the device.
            seed = torch.randint(0, 2**31 - 1, (1,), generator=dropout_generator,
                                 device=q.device, dtype=torch.int32)
        if flash_mesh is not None and flash_mesh.size > 1:
            return sharded_relative_flash_attention(
                q, k, v, rel_embedding, mesh=flash_mesh, scale=scale,
                dropout_rate=dropout_rate, dropout_seed=seed)
        return relative_flash_attention(q, k, v, rel_embedding, scale=scale,
                                        dropout_rate=dropout_rate, dropout_seed=seed)

    w = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if rel_embedding is not None:
        if s_q == s_k and q_position is None:
            w = w + relative_logits_full(q, rel_embedding)
        else:
            if q_position is None:
                raise ValueError(
                    "q_position is required for relative attention with a KV cache."
                )
            w = w + relative_logits_decode(q, rel_embedding, q_position, s_k)

    if scale:
        w = w * torch.rsqrt(torch.tensor(float(q.shape[-1]), dtype=compute_dtype))

    if mask is None:
        offset = q_position if q_position is not None else s_k - s_q
        mask = causal_mask(s_q, s_k, q_offset=offset, dtype=compute_dtype,
                           device=q.device)
    mask = mask.to(compute_dtype)
    w = w * mask - 1e4 * (1 - mask)
    w = torch.softmax(w.float(), dim=-1).to(compute_dtype)
    if dropout_rate > 0.0:
        keep = torch.rand(w.shape, generator=dropout_generator, device=w.device) < 1.0 - dropout_rate
        w = w * keep.to(compute_dtype) / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)
