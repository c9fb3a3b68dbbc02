"""Single-sequence fused decoding, and the helpers every decode kernel shares.

Port of ``composer_tpu/ops/decode_kernel.py``. The TPU kernel
``_decode_kernel`` is replaced by the batch-1 form of the Hopper kernel
``decode_generate`` (``csrc/decode_generate.cu``, driven from
``ops/decode_kernel_batched.py``): ``megakernel_generate`` and
``megakernel_decode`` below are thin entry points onto it.

Shared here, as in the JAX package:

* ``pack_weights``: the stacked weights the kernel reads, with ln_2 folded
  into ``fc_w``/``fc_b`` and ln_f into ``wte_t`` plus ``logits_b``, and the
  vocabulary padded to a multiple of 256;
* ``cache_to_rows`` / ``cache_to_rows_batched``: a prefilled ``[B, H, S, D]``
  cache in the kernel's ``(L, B*C, E)`` row layout;
* ``filtered_scaled_logits``: the kernel's top-k / top-p definition;
* ``philox_bits`` / ``gumbel_noise``: the counter-based random bits the
  kernel draws, so that the kernel and its plain version sample the same ids.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def _round_up(value: int, multiple: int) -> int:
    return (value + multiple - 1) // multiple * multiple


def vocab_pad(config) -> int:
    return _round_up(config.vocab_size, 256)


def pack_weights(state_dict, config, dtype=torch.bfloat16, device=None):
    """The port's ``state_dict`` -> the stacked tensors the kernel consumes.

    Matmul weights are ``(in, out)``, as in the JAX package. ln_2 and ln_f
    are folded away: for ``y = LN(x) @ W + b`` with
    ``LN(x) = std(x) * gamma + beta`` the kernel computes ``std(x) @ W' + b'``
    with ``W' = diag(gamma) @ W`` and ``b' = beta @ W + b``. Folding happens
    in float32, then matmul weights are cast to ``dtype``; biases and ln_1
    stay float32.
    """
    def f32(name):
        return state_dict[name].detach().to(device=device, dtype=torch.float32)

    E = config.embed_dim
    vpad = vocab_pad(config)
    layers = [f"h_{i + 1}" for i in range(config.num_layers)]

    wte = f32("wte")
    wte_pad = torch.nn.functional.pad(wte, (0, 0, 0, vpad - wte.shape[0]))

    def kernel(name):  # nn.Linear (out, in) -> (in, out)
        return f32(f"{name}.weight").t()

    def stack(tensors, out_dtype):
        return torch.stack(tensors).to(out_dtype).contiguous()

    fc_w, fc_b = [], []
    for block in layers:
        gamma, beta = f32(f"{block}.ln_2.weight"), f32(f"{block}.ln_2.bias")
        w = kernel(f"{block}.mlp.c_fc")
        fc_w.append(gamma[:, None] * w)
        fc_b.append(beta @ w + f32(f"{block}.mlp.c_fc.bias"))

    gamma_f, beta_f = f32("ln_f.weight"), f32("ln_f.bias")
    wte_t = wte_pad.t()
    packed = {
        "wte": wte_pad.to(dtype).contiguous(),
        "wte_t": (gamma_f[:, None] * wte_t).to(dtype).contiguous(),  # (E, Vpad)
        "wpe": f32("wpe").to(dtype).contiguous(),
        "ln1": torch.stack([
            torch.stack([f32(f"{b}.ln_1.weight"), f32(f"{b}.ln_1.bias")]) for b in layers
        ]).contiguous(),  # (L, 2, E)
        "qkv_w": stack([kernel(f"{b}.attn.c_attn") for b in layers], dtype),
        "qkv_b": stack([f32(f"{b}.attn.c_attn.bias")[None] for b in layers], torch.float32),
        "proj_w": stack([kernel(f"{b}.attn.c_proj") for b in layers], dtype),
        "proj_b": stack([f32(f"{b}.attn.c_proj.bias")[None] for b in layers], torch.float32),
        "fc_w": stack(fc_w, dtype),
        "fc_b": stack([b[None] for b in fc_b], torch.float32),
        "fp_w": stack([kernel(f"{b}.mlp.c_proj") for b in layers], dtype),
        "fp_b": stack([f32(f"{b}.mlp.c_proj.bias")[None] for b in layers], torch.float32),
        "logits_b": (beta_f @ wte_t)[None].contiguous(),  # (1, Vpad) f32
    }
    if config.use_relative_attention:
        # rel_rows[l, r, h*D + d] = E[h, r, d]: the cache-row layout.
        rel = torch.stack([f32(f"{b}.attn.rel_embedding") for b in layers])  # (L, H, W, D)
        packed["rel_rows"] = rel.permute(0, 2, 1, 3).reshape(
            config.num_layers, config.window_size, E
        ).to(dtype).contiguous()
    else:
        packed["rel_rows"] = torch.zeros((config.num_layers, 8, E), dtype=dtype, device=device)
    return packed


def cache_to_rows_batched(cache, config, cache_len: int, dtype=torch.bfloat16):
    """``[B, H, S, D]`` layer caches -> ``(L, B*cache_len, H*D)`` rows: sequence
    s's slot c at row ``s*cache_len + c``. Rows beyond the prefilled range
    are zeros."""
    k_layers, v_layers = [], []
    for layer in cache["layers"]:
        rows = []
        for name in ("k", "v"):
            buf = layer[name].to(dtype).transpose(1, 2)  # (B, S, H, D)
            batch, s_len = buf.shape[0], buf.shape[1]
            buf = buf.reshape(batch, s_len, -1)[:, :cache_len]
            if buf.shape[1] < cache_len:
                buf = torch.nn.functional.pad(buf, (0, 0, 0, cache_len - buf.shape[1]))
            rows.append(buf.reshape(batch * cache_len, -1))
        k_layers.append(rows[0])
        v_layers.append(rows[1])
    return torch.stack(k_layers).contiguous(), torch.stack(v_layers).contiguous()


def cache_to_rows(cache, config, cache_len: int, dtype=torch.bfloat16):
    """``[1, H, S, D]`` layer caches -> ``(L, cache_len, H*D)`` rows."""
    if cache["layers"][0]["k"].shape[0] != 1:
        raise ValueError("cache_to_rows takes a batch-1 cache; use cache_to_rows_batched")
    return cache_to_rows_batched(cache, config, cache_len, dtype)


def sampling_flags(temperature, top_k, top_p, greedy=None, use_k=None, use_p=None):
    """Kernel-structure flags from concrete sampling values: ``greedy`` (no
    row samples), ``use_k`` / ``use_p`` (some row filters)."""
    if greedy is None:
        greedy = bool(np.all(np.asarray(temperature) <= 0))
    if use_k is None:
        use_k = bool(np.any(np.asarray(top_k) > 0))
    if use_p is None:
        p = np.asarray(top_p, np.float64)
        use_p = bool(np.any((p > 0) & (p < 1)))
    return greedy, use_k, use_p


def row_params(batch: int, vpad: int, temperature, top_k, top_p, greedy, use_k,
               use_p, device):
    """Scalar-or-per-row sampling values -> the kernel's ``(B,)`` float32
    vectors. Disabled filters carry always-true sentinels (rank < Vpad+1,
    strict mass-before < 2), so a row that asked for no filtering is never
    changed; ``greedy`` zeroes every temperature."""
    def rows(value):
        t = torch.as_tensor(np.asarray(value, np.float32).reshape(-1))
        return t.expand(batch).clone() if t.numel() == 1 else t

    temps = rows(temperature)
    topk = rows(top_k)
    topp = rows(top_p)
    if temps.shape[0] != batch or topk.shape[0] != batch or topp.shape[0] != batch:
        raise ValueError(f"sampling values must be scalars or length-{batch} vectors")
    if greedy:
        temps = torch.zeros(batch)
    topk = torch.where((topk > 0) & use_k, topk, torch.tensor(float(vpad + 1)))
    topp = torch.where((topp > 0) & (topp < 1) & use_p, topp, torch.tensor(2.0))
    return temps.to(device), topk.to(device), topp.to(device)


def _threshold_rows(value, n: int, device):
    """None / a non-positive number disables a filter; a positive number
    applies to every row; a sequence or tensor gives one threshold per row
    (disabled rows carry the sentinels)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        if value <= 0:
            return None
        return torch.full((n,), float(value), device=device)
    t = torch.as_tensor(value, dtype=torch.float32, device=device).reshape(-1)
    if t.numel() == 1:
        t = t.expand(n)
    if t.shape[0] != n:
        raise ValueError(f"expected {n} per-row thresholds, got {t.shape[0]}")
    return t


def filtered_scaled_logits(scaled, top_k, top_p):
    """Top-k / nucleus filtering with the fused kernel's definition.

    ``scaled``: ``(N, Vpad)`` float32 rows, padding lanes near ``NEG_INF``.
    Both filters look at the unfiltered row, and ties are kept:

        survives top-k  iff  #{j: x_j > x_i} < k
        survives top-p  iff  sum_{j: x_j > x_i} softmax(x)_j < p

    The nucleus mass is summed in float64 (``exp`` in float32, as in the
    kernel), so its comparison with ``p`` does not depend on summation order.
    With both filters on this differs from ``ops/sampling.py``, which applies
    top-p to the renormalised top-k survivors.

    The kernel counts by comparing every pair of lanes; here a sort gives
    the same counts and masses in O(V log V) per row.
    """
    n, vpad = scaled.shape
    k = _threshold_rows(top_k, n, scaled.device)
    p = _threshold_rows(top_p, n, scaled.device)
    if k is None and p is None:
        return scaled
    ascending = torch.sort(scaled, dim=-1).values
    # #{j: x_j > x_i}: the lanes sorted after x_i's last tie.
    above = vpad - torch.searchsorted(ascending, scaled, right=True)
    keep = torch.ones_like(scaled, dtype=torch.bool)
    if k is not None:
        keep &= above < k[:, None]
    if p is not None:
        e = torch.exp(ascending - ascending[:, -1:]).double()
        # suffix[:, m] = sum of e over sorted lanes m..V-1 (suffix[:, V] = 0).
        suffix = torch.cat([e.flip(-1).cumsum(-1).flip(-1), e.new_zeros(n, 1)], dim=-1)
        mass = torch.gather(suffix, -1, vpad - above) / suffix[:, :1]
        keep &= mass < p[:, None].double()
    return torch.where(keep, scaled, torch.tensor(NEG_INF, device=scaled.device))


# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3").
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of ``m * x`` for uint32 values held in int64,
    split so no intermediate leaves int64."""
    p0 = (x & 0xFFFF) * m  # < 2**48
    p1 = (x >> 16) * m  # < 2**48
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (t >> 32), t & _MASK32


def philox_bits(seed: int, rows: int, step: int, vpad: int, device=None) -> torch.Tensor:
    """The kernel's random bits: ``(rows, vpad)`` uint32 values in int64.

    Lane v of row s at step t is word ``v % 4`` of Philox4x32-10 with counter
    ``(v // 4, t, s, 0)`` and key ``(seed, 0)``.
    """
    groups = vpad // 4
    c0 = torch.arange(groups, dtype=torch.int64, device=device)[None, :].expand(rows, groups)
    c1 = torch.full((rows, groups), step & _MASK32, dtype=torch.int64, device=device)
    c2 = torch.arange(rows, dtype=torch.int64, device=device)[:, None].expand(rows, groups)
    c3 = torch.zeros((rows, groups), dtype=torch.int64, device=device)
    k0, k1 = seed & _MASK32, 0
    for round_index in range(10):
        if round_index:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1).reshape(rows, vpad)


def gumbel_noise(seed: int, rows: int, step: int, vpad: int, device=None) -> torch.Tensor:
    """``g = -log(-log u)`` with ``u = (bits >> 9) * 2**-23 + 1e-12`` (float32)."""
    bits = philox_bits(seed, rows, step, vpad, device)
    uniform = (bits >> 9).to(torch.float32) * (1.0 / (1 << 23)) + 1e-12
    return -torch.log(-torch.log(uniform))


def first_argmax(x):
    """Index of the first maximum along the last axis."""
    peak = x.max(dim=-1, keepdim=True).values
    lanes = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    return torch.where(x == peak, lanes, x.shape[-1]).min(dim=-1).values


def sample_rows(logits, temps, topk, topp, seed: int, step: int, use_filters: bool = True):
    """One sampling step of the fused kernel, for ``(B, Vpad)`` logits.

    A row with temperature <= 0 takes the argmax of its logits. Other rows
    scale by ``1 / temperature``, filter (``filtered_scaled_logits``), add
    the Philox Gumbel noise of ``(seed, row, step)`` and take the first
    maximum.
    """
    greedy = temps <= 0
    inv_temp = 1.0 / torch.where(greedy, torch.ones_like(temps), temps)
    scaled = logits * inv_temp[:, None]
    if use_filters:
        scaled = filtered_scaled_logits(scaled, topk, topp)
    sampled = scaled + gumbel_noise(seed, logits.shape[0], step, logits.shape[1], logits.device)
    return first_argmax(torch.where(greedy[:, None], logits, sampled))


def megakernel_decode(packed, k_rows, v_rows, start_pos, token0, seed, temperature,
                      *, config, num_steps: int, cache_len: int, top_k=0, top_p=0.0,
                      greedy=None, use_k=None, use_p=None):
    """Runs ``num_steps`` single-token decode steps from a prefilled cache.

    ``k_rows``/``v_rows``: ``(L, cache_len, E)`` rows (``cache_to_rows``)
    holding positions ``[0, start_pos)``; ``token0`` is the input at
    ``start_pos``. Returns the ``(num_steps,)`` sampled ids.
    """
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate

    device = packed["wte"].device
    greedy, use_k, use_p = sampling_flags(temperature, top_k, top_p, greedy, use_k, use_p)
    temps, topk, topp = row_params(1, packed["wte"].shape[0], temperature, top_k, top_p,
                                   greedy, use_k, use_p, device)
    # The token0 input sits at prompt column start_pos; earlier columns are
    # covered by the prefilled cache and never read.
    prompt = torch.zeros((1, start_pos + 1), dtype=torch.int32, device=device)
    prompt[0, start_pos] = int(token0)
    plens = torch.full((1,), start_pos + 1, dtype=torch.int32, device=device)
    tokens = decode_generate(
        packed, prompt, plens, seed, temps, topk, topp, k_rows, v_rows,
        config=config, num_steps=start_pos + num_steps, out_len=num_steps,
        cache_len=cache_len, start_step=start_pos,
    )
    return tokens[0]


def megakernel_generate(packed, prompt, seed, temperature, *, config, length: int,
                        cache_len: int, top_k=0, top_p=0.0, greedy=None, use_k=None,
                        use_p=None):
    """Whole single-sequence generation in one kernel launch: the prompt is
    consumed teacher-forced inside the kernel. Returns ``(length,)`` ids."""
    from composer_tpu_torch.ops.decode_kernel_batched import megakernel_generate_batched

    prompt = torch.as_tensor(prompt, dtype=torch.int32).reshape(1, -1)
    return megakernel_generate_batched(
        packed, prompt, seed, temperature, config=config, length=length,
        cache_len=cache_len, top_k=top_k, top_p=top_p, greedy=greedy,
        use_k=use_k, use_p=use_p,
    )[0]
