"""Per-row sampling for the unfused decode path.

Port of the per-row half of ``composer_tpu/ops/sampling.py``. Each parameter
is a ``[B]`` vector, so one call serves a batch with mixed settings. The
warpers apply in the canonical order: temperature, then top-k, then top-p
over the top-k survivors (the fused kernel computes both filters on the
unfiltered row instead; see ``ops/decode_kernel.py``).
"""

from __future__ import annotations

import torch


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
    probs = torch.softmax(filtered, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[..., 0]
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
