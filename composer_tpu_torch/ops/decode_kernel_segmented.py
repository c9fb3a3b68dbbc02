"""Segmented batched decoding with per-row positions: continuous batching.

Port of ``composer_tpu/ops/decode_kernel_segmented.py``. The Hopper kernel
``decode_segment`` (``csrc/decode_segment.cu``, CUDA C++ for ``sm_90a``)
replaces the TPU kernel ``_segment_kernel``.

The token loop runs in SEGMENTS of a fixed step count with the KV cache
and the carry kept on the card between calls, so a serving scheduler
(``serving.py::ContinuousGenerationService``) can admit a request into a
running batch and evict finished rows at every segment boundary. Slot s was
admitted at global step ``starts[s]`` and sits at position
``i - starts[s]``: while that position is inside its prompt the row is
teacher-forced, afterwards it feeds back its own sample. A row with a
negative position is parked (``PARKED`` marks an empty slot): it emits -1
and writes nothing. Every row reads only cache rows it wrote itself, so a
new occupant needs no zeroing.

The port's layout differs from the TPU kernel's where the TPU forced it:
the caches are ``(L, B*cache_len, E)`` in the weights' dtype (the layout of
``decode_generate`` and ``cache_to_rows_batched``, without 128-lane
padding), and the carry is each slot's next input token ``(B,)`` int32,
not a one-hot. The kernel updates the caches and the carry in place.

The random bits of slot s at global step i are Philox4x32-10 keyed by
(seed, s, i, lane), the counterpart of the TPU kernel's reseeding from
``seed + i * _STEP_SEED_MIX``: a row's sampled stream does not depend on
how the loop is cut into segments, nor on when other rows were admitted,
and the kernel and its plain version sample identical ids.
"""

from __future__ import annotations

import numpy as np
import torch

from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops.decode_kernel_batched import (
    MAX_SHARED_BYTES,
    NEG_INF,
    _check_cuda_inputs,
    _gelu_tanh,
    _logits_bias,
    _standardize,
    kernel_fits,
    kernel_smem_bytes,
    launch_cluster_size,
)

PARKED = 2**30  # start value for empty slots: never reached


def init_segment_state(packed, config, batch: int, cache_len: int):
    """Fresh carried state for ``batch`` slots: zeroed ``(L, batch*cache_len,
    E)`` K and V caches in the weights' dtype and a zero carry; the step
    that admits a row takes its first input from its prompt."""
    shape = (config.num_layers, batch * cache_len, config.embed_dim)
    device, dtype = packed["wte"].device, packed["wte"].dtype
    kcache = torch.zeros(shape, dtype=dtype, device=device)
    return kcache, torch.zeros_like(kcache), torch.zeros(batch, dtype=torch.int32, device=device)


def segment_kernel_fits(config, live: int) -> bool:
    """The kernel's limits for a segment whose attention reads ``live`` cache
    rows: the ``H x live`` float32 scores, the activations and the static
    shared bytes within 227 KB (the accounting of ``kernel_fits``; for the
    default model live <= 3067), and head_dim a multiple of 8."""
    return kernel_fits(config, live)


def decode_segment_reference(packed, kcache, vcache, carry, prompts, plens, starts,
                             step0: int, seed: int, temps, topk, topp, *, config,
                             steps: int, cache_len: int, live: int):
    """The plain PyTorch version of the kernel (same contract as
    ``decode_segment``, with the sampling values already ``(B,)`` float32
    sentinel vectors of ``row_params``). Numerics as
    ``decode_generate_reference``. Updates ``kcache``, ``vcache`` and
    ``carry`` in place and returns ``(tokens, kcache, vcache, carry)``."""
    device, wdtype = packed["wte"].device, packed["wte"].dtype
    B, P = prompts.shape
    L, H, D, E = config.num_layers, config.num_heads, config.head_dim, config.embed_dim
    W, eps = config.window_size, config.layer_norm_epsilon
    live = min(live, cache_len)
    prompts, plens, starts = prompts.long(), plens.long(), starts.long()
    if bool(((plens < 1) | (plens > P)).any()):
        raise ValueError(f"prompt lengths must lie in [1, {P}]")
    use_filters = bool(((topk < packed["wte"].shape[0]) | (topp < 1)).any())
    w32 = {name: packed[name].float() for name in (
        "wte", "wte_t", "wpe", "qkv_w", "proj_w", "fc_w", "fp_w", "rel_rows")}
    logits_b = _logits_bias(packed, config)
    scale = float(D) ** -0.5 if config.scale_attention else 1.0
    kc = kcache.view(L, B, cache_len, E)
    vc = vcache.view(L, B, cache_len, E)
    rows = torch.arange(B, device=device)
    slots = torch.arange(live, device=device)

    def mm(x, w):
        return x.to(wdtype).float() @ w

    def prompt_at(pos):  # each row's prompt token at pos, clamped into the prompt
        return prompts[rows, torch.minimum(pos.clamp(min=0), plens - 1)]

    pos0 = step0 - starts
    token = torch.where(pos0 < plens, prompt_at(pos0), carry.long())
    tokens = torch.full((B, steps), -1, dtype=torch.int32, device=device)
    for j in range(steps):
        i = step0 + j
        pos = i - starts
        active = pos >= 0
        key_pos = pos.clamp(0, live - 1)
        written = rows[active & (pos < live)]
        h = w32["wte"][token] + w32["wpe"][pos.clamp(0, W - 1)]
        for layer in range(L):
            ln1 = packed["ln1"][layer]
            x1 = _standardize(h, eps) * ln1[0] + ln1[1]
            qkv = mm(x1, w32["qkv_w"][layer]) + packed["qkv_b"][layer]
            q, k, v = qkv[:, :E], qkv[:, E:2 * E], qkv[:, 2 * E:]
            kc[layer, written, key_pos[written]] = k[written].to(wdtype)
            vc[layer, written, key_pos[written]] = v[written].to(wdtype)
            qw = q.to(wdtype).float().reshape(B, H, D)
            scores = torch.einsum("bhd,bchd->bhc", qw,
                                  kc[layer, :, :live].float().reshape(B, live, H, D))
            if config.use_relative_attention:
                r = W - 1 - (key_pos[:, None] - slots[None, :])  # (B, live)
                band = w32["rel_rows"][layer][r.clamp(0, W - 1)] * (r >= 0)[..., None]
                scores = scores + torch.einsum("bhd,bchd->bhc", qw, band.reshape(B, live, H, D))
            scores = torch.where(slots <= key_pos[:, None, None], scores * scale, NEG_INF)
            p = torch.exp(scores - scores.max(dim=-1, keepdim=True).values)
            weights = (p / p.sum(-1, keepdim=True)).to(wdtype).float()
            attn = torch.einsum("bhc,bchd->bhd", weights,
                                vc[layer, :, :live].float().reshape(B, live, H, D)).reshape(B, E)
            x2 = x1 + (mm(attn, w32["proj_w"][layer]) + packed["proj_b"][layer])
            hidden = _gelu_tanh(mm(_standardize(x2, eps), w32["fc_w"][layer])
                                + packed["fc_b"][layer])
            h = x2 + mm(hidden, w32["fp_w"][layer]) + packed["fp_b"][layer]
        logits = mm(_standardize(h, eps), w32["wte_t"]) + logits_b
        sample = dk.sample_rows(logits, temps, topk, topp, seed, i, use_filters)
        tokens[:, j] = torch.where(active, sample, -1).to(torch.int32)
        token = torch.where(pos + 1 < plens, prompt_at(pos + 1), sample)
    carry.copy_(token)
    return tokens, kcache, vcache, carry


def _upload(value, dtype, device):
    """A fresh ``dtype`` tensor of ``value`` on ``device``. Host values go
    through pinned memory with a non-blocking copy, so a dispatch does not
    wait for the segment in flight; each call owns its copy, so the host may
    rewrite its arrays while the kernel reads."""
    if isinstance(value, torch.Tensor):
        if value.device == device and value.dtype == dtype:
            return value.contiguous()
        value = value.cpu()
    host = torch.tensor(np.asarray(value), dtype=dtype)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def decode_segment(packed, kcache, vcache, carry, prompts, plens, starts, step0: int,
                   seed: int, temperature, top_k, top_p, *, config, steps: int,
                   cache_len: int, live: int, greedy=None, use_k=None, use_p=None):
    """Runs decode steps ``[step0, step0 + steps)`` over the slot batch.

    ``kcache``/``vcache``: ``(L, B*cache_len, E)`` in the weights' dtype;
    ``carry``: ``(B,)`` int32 (``init_segment_state``). ``prompts (B, P)``,
    ``plens (B,)`` in [1, P] and ``starts (B,)`` int32 (``PARKED`` for an
    empty slot), as host arrays or tensors. ``temperature``/``top_k``/
    ``top_p`` are host scalars or per-row vectors (a row with temperature
    <= 0 is greedy; ``greedy``/``use_k``/``use_p`` as in the JAX package).
    ``live`` bounds the cache rows attention reads: a row whose position
    reaches it attends to ``[0, live)`` and writes nothing.

    Returns ``(tokens, kcache, vcache, carry)``: tokens ``(B, steps)`` int32,
    row s's raw sample after each step, -1 while parked (the scheduler
    gathers a generation from column ``starts + plens - 1 - step0`` on); the
    state is updated in place. On CPU tensors this is the plain version; on
    CUDA tensors it launches the kernel as B clusters of ``cluster_size``
    blocks (G, kept in ``decode_segment.cluster``; counted in
    ``decode_segment.launches``) or raises.
    """
    device, wdtype = packed["wte"].device, packed["wte"].dtype
    B = prompts.shape[0]
    vpad = packed["wte"].shape[0]
    live = min(int(live), cache_len)
    greedy, use_k, use_p = dk.sampling_flags(temperature, top_k, top_p, greedy, use_k, use_p)
    rows = dk.row_params(B, vpad, temperature, top_k, top_p, greedy, use_k, use_p, "cpu")
    temps, topk, topp = (_upload(t, torch.float32, device) for t in rows)
    prompts, plens, starts = (_upload(t, torch.int32, device) for t in (prompts, plens, starts))
    if device.type == "cpu":
        return decode_segment_reference(
            packed, kcache, vcache, carry, prompts, plens, starts, step0, seed, temps, topk,
            topp, config=config, steps=steps, cache_len=cache_len, live=live)
    if device.type != "cuda":
        raise ValueError(f"decode_segment runs on CPU or CUDA tensors, not {device}")
    if not segment_kernel_fits(config, live):
        raise ValueError(
            f"the kernel takes head_dim % 8 == 0 and at most {MAX_SHARED_BYTES} bytes of "
            f"shared memory; live {live} needs {kernel_smem_bytes(config, live)}, head_dim "
            f"is {config.head_dim}")
    import ctypes

    from composer_tpu_torch.ops._build import load_library

    L, E = config.num_layers, config.embed_dim
    if wdtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes float32 or bfloat16 weights, not {wdtype}")
    if kcache.shape != (L, B * cache_len, E) or vcache.shape != kcache.shape:
        raise ValueError(f"caches must be {(L, B * cache_len, E)}, got {tuple(kcache.shape)}")
    if carry.shape != (B,) or carry.dtype != torch.int32 or carry.device != device:
        raise ValueError(f"carry must be a ({B},) int32 tensor on {device}")
    if any(t.shape != (B,) for t in (plens, starts)) or steps < 1 or live < 1:
        raise ValueError("plens and starts must be (B,), steps and live positive")
    if packed["wte_t"].shape != (E, vpad) or packed["qkv_w"].shape != (L, E, 3 * E):
        raise ValueError("packed weights do not match the config")
    if config.use_relative_attention and packed["rel_rows"].shape[1] != config.window_size:
        raise ValueError("rel_rows must hold window_size rows with relative attention on")
    logits_b = _logits_bias(packed, config)
    inputs = {name: packed[name] for name in (
        "wte", "wte_t", "wpe", "ln1", "qkv_w", "qkv_b", "proj_w", "proj_b",
        "fc_w", "fc_b", "fp_w", "fp_b", "rel_rows")}
    inputs.update(logits_b=logits_b, kcache=kcache, vcache=vcache, prompts=prompts,
                  plens=plens, starts=starts, temps=temps, topk=topk, topp=topp)
    _check_cuda_inputs(inputs, device, wdtype)
    tokens = torch.empty((B, steps), dtype=torch.int32, device=device)

    lib = load_library("decode_segment")
    cluster = launch_cluster_size("decode_segment", config, B, live, wdtype, device)
    ptr = ctypes.c_void_p
    err = lib.decode_segment(
        ctypes.c_int(1 if wdtype == torch.bfloat16 else 0),
        ctypes.c_int(device.index if device.index is not None else torch.cuda.current_device()),
        *(ptr(inputs[name].data_ptr()) for name in (
            "wte", "wte_t", "wpe", "ln1", "qkv_w", "qkv_b", "proj_w", "proj_b",
            "fc_w", "fc_b", "fp_w", "fp_b", "logits_b", "rel_rows", "kcache", "vcache")),
        ptr(carry.data_ptr()),
        *(ptr(t.data_ptr()) for t in (prompts, plens, starts, temps, topk, topp, tokens)),
        *(ctypes.c_int(int(v)) for v in (
            B, prompts.shape[1], L, config.num_heads, config.head_dim, E, cache_len,
            config.window_size, vpad, step0, steps, live, config.use_relative_attention)),
        ctypes.c_uint(int(seed) & 0xFFFFFFFF),
        ctypes.c_float(float(config.head_dim) ** -0.5 if config.scale_attention else 1.0),
        ctypes.c_float(config.layer_norm_epsilon),
        ctypes.c_int(cluster),
        ptr(torch.cuda.current_stream(device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"decode_segment kernel launch failed (cluster {cluster}): "
                           f"CUDA error {err}")
    decode_segment.launches += 1
    decode_segment.cluster = cluster
    return tokens, kcache, vcache, carry


decode_segment.launches = 0
decode_segment.cluster = None  # G of the last launch
