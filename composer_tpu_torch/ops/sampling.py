"""Sampling for the unfused decode path: port of ``composer_tpu/ops/sampling.py``.

The scalar samplers (``sample_logits``, ``filter_top_k``, ``sample_top_k``,
``filter_top_p``, ``sample_filtered``) take one setting for every row; the
per-row forms (``*_rows``) take ``[B]`` vectors, so one call serves a batch
with mixed settings. Where a row's setting equals a scalar one, both give
the same filtered logits. The warpers apply in the canonical order:
temperature, then top-k, then top-p over the top-k survivors (the fused
kernel computes both filters on the unfiltered row instead; see
``ops/decode_kernel.py``). Random draws come from a ``torch.Generator`` on
the logits' device.
"""

from __future__ import annotations

import torch


def _categorical(generator: torch.Generator, logits):
    """One draw per row of ``logits`` ``[..., V]`` (-inf entries never)."""
    probs = torch.softmax(logits.float(), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])


def sample_logits(generator: torch.Generator, logits, temperature: float = 1.0):
    """Temperature-scaled categorical sampling over the last axis;
    ``temperature <= 0`` is the argmax. Returns int64 ids of shape
    ``logits.shape[:-1]``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    return _categorical(generator, logits.float() / temperature)


def filter_top_k(logits, k: int):
    """Keeps the k largest logits (ties at the k-th value too); the rest go
    to -inf."""
    threshold = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < threshold, -torch.inf, logits)


def sample_top_k(generator: torch.Generator, logits, temperature: float = 1.0, k: int = 0):
    """Top-k filtered temperature sampling (``k <= 0`` disables the filter)."""
    if k and k > 0:
        logits = filter_top_k(logits, k)
    return sample_logits(generator, logits, temperature)


def filter_top_p(logits, p: float):
    """Nucleus filtering: keeps the smallest probability-sorted prefix whose
    mass reaches ``p`` (the token that crosses ``p`` is kept); the rest go to
    -inf."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    keep_sorted = (cumulative - probs) < p
    kept = torch.where(keep_sorted, sorted_logits, torch.inf)
    threshold = kept.min(dim=-1, keepdim=True).values
    return torch.where(logits < threshold, -torch.inf, logits)


def sample_filtered(generator: torch.Generator, logits, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 0.0):
    """Temperature sampling with optional top-k and nucleus filtering, in
    the canonical order (temperature, top-k, then top-p over the
    survivors). ``top_k <= 0`` and ``top_p`` outside (0, 1) disable each
    filter; with both disabled this is :func:`sample_logits`."""
    greedy = temperature <= 0
    if not greedy:
        logits = logits.float() / temperature
    if top_k and top_k > 0:
        logits = filter_top_k(logits, top_k)
    if top_p and 0.0 < top_p < 1.0:
        logits = filter_top_p(logits, top_p)
    return sample_logits(generator, logits, 0.0 if greedy else 1.0)


def filter_top_k_rows(logits, k):
    """Per-row top-k: ``k`` is an int ``[B]`` vector; ``k[i] <= 0`` disables
    row i. Ties at the k-th value are kept (x survives iff x >= k-th
    largest)."""
    vocab = logits.shape[-1]
    k = torch.as_tensor(k, dtype=torch.int64, device=logits.device)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    index = (k - 1).clamp(0, vocab - 1)
    threshold = torch.gather(sorted_desc, -1, index[..., None])
    enabled = (k > 0)[..., None]
    return torch.where(enabled & (logits < threshold), -torch.inf, logits)


def filter_top_p_rows(logits, p):
    """Per-row nucleus filtering: ``p`` is a float ``[B]`` vector; values
    outside (0, 1) disable the row. The token that crosses ``p`` is kept."""
    p = torch.as_tensor(p, dtype=torch.float32, device=logits.device)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    keep_sorted = (cumulative - probs) < p[..., None]
    kept = torch.where(keep_sorted, sorted_logits, torch.inf)
    threshold = kept.min(dim=-1, keepdim=True).values
    enabled = ((p > 0.0) & (p < 1.0))[..., None]
    return torch.where(enabled & (logits < threshold), -torch.inf, logits)


def sample_filtered_rows(generator: torch.Generator, logits, temperature, top_k, top_p):
    """Per-row temperature / top-k / top-p sampling of ``logits`` ``[B, V]``.

    ``temperature[i] <= 0`` makes row i greedy (argmax of the raw logits;
    filters cannot change an argmax). ``generator`` lives on the logits'
    device.
    """
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    greedy = temperature <= 0.0
    safe = torch.where(greedy, torch.ones_like(temperature), temperature)
    scaled = logits.float() / safe[..., None]
    filtered = filter_top_p_rows(filter_top_k_rows(scaled, top_k), top_p)
    sampled = _categorical(generator, filtered)
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
