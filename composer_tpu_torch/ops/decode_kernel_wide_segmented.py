"""Segmented decoding with streamed weights: continuous batching for models
whose weights outgrow the card's fast memory.

Port of ``composer_tpu/ops/decode_kernel_wide_segmented.py``. The Hopper
kernel ``decode_wide_segment`` (``csrc/decode_wide_segment.cu``, CUDA C++
for ``sm_90a``) replaces the TPU kernel ``_wide_segment_kernel``.

It joins the two kernels it stands between: the weights stream from HBM as
in ``decode_wide``, whose step body it runs (one cooperative launch, a block
per SM, each weight byte read once per step for all live rows), and each
slot keeps its own clock as
in ``decode_segment``: slot s, admitted at global step ``starts[s]``, sits
at position ``i - starts[s]``, teacher-forced inside its prompt, fed back
its own sample after; a negative position is parked (``PARKED``), emits -1
and writes nothing. The K/V cache and the carry stay on the card between
segments, so ``serving.py::ContinuousGenerationService(engine="wide")`` can
admit and evict at every segment boundary.

What the port keeps of the TPU kernel is its semantics, not its layout: the
K/V state is ``decode_wide``'s ``(L, 2, B, cache_len, E)`` in the
activation dtype and a step writes its row straight to it. The TPU's
per-row HBM rows, the tail windows flushed and reloaded at every segment
boundary, the streamed K/V chunks and the shared relative-bias slice exist
for VMEM and DMA and have no counterpart. There is no int8 K/V, as in the
TPU kernel; int8 weights (``pack_weights_wide(dtype=torch.int8)``) are
taken.

The random bits of slot s at global step i are Philox4x32-10 keyed by
(seed, s, i, lane), ``decode_segment``'s key: a row's sampled stream does
not depend on how the loop is cut into segments nor on when other rows were
admitted, and in float32 it is what ``decode_segment`` samples.
"""

from __future__ import annotations

import numpy as np
import torch

from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops.decode_kernel_batched import (
    KERNEL_THREADS,
    MAX_SHARED_BYTES,
    NEG_INF,
    _gelu_tanh,
    _logits_bias,
    _standardize,
)
from composer_tpu_torch.ops.decode_kernel_segmented import PARKED, _upload
from composer_tpu_torch.ops.decode_kernel_wide import (
    _WEIGHT_KINDS,
    MAX_BATCH,
    PHASES,
    _check_cuda_tensors,
    _check_packed,
    _scratch_floats,
    init_kv_state,
    pack_weights_wide,
    wide_smem_bytes,
)

__all__ = [
    "MAX_BATCH", "PARKED", "PHASES", "decode_segment_wide", "decode_segment_wide_reference",
    "init_wide_segment_state", "pack_weights_wide", "wide_segment_kernel_fits",
    "wide_segment_smem_bytes",
]

# The per-step row list, the weight stages' mbarriers and their tile
# geometry, at the front of the kernel's shared memory (kInfoBytes in
# csrc/decode_wide_common.cuh; part of HEADER_BYTES, which decode_wide
# shares).
STEP_INFO_BYTES = 512


def init_wide_segment_state(packed, config, batch: int, cache_len: int):
    """Fresh carried state for ``batch`` slots: a zeroed K/V cache ``(L, 2,
    batch, cache_len, E)`` in the activation dtype (``init_kv_state``'s
    layout) and a zero carry ``(batch,)`` int32; the step that admits a row
    takes its first input from its prompt. Every row reads only cache rows
    it wrote itself, so a new occupant needs no zeroing."""
    device = packed["wte"].device
    kv = init_kv_state(config, batch, cache_len, packed["wte"].dtype, device=device)
    return kv, torch.zeros(batch, dtype=torch.int32, device=device)


def wide_segment_smem_bytes(config, batch: int, live: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one block: ``decode_wide``'s layout (the two
    kernels run one step body), whose header holds the row list. ``live``
    no longer matters: attention keeps no per-key buffer."""
    return wide_smem_bytes(config, batch, live, dtype)


def wide_segment_kernel_fits(config, batch: int, live: int, dtype=torch.bfloat16) -> bool:
    """The kernel's limits for ``batch`` slots reading ``live`` cache rows:
    at most ``MAX_BATCH`` slots (the tensor-core products' 8 rows), shared
    memory within 227 KB, and ``decode_wide``'s widths (embed % 16 == 0,
    head_dim a multiple of 8 up to 128 dividing 512). The counterpart of the
    JAX package's ``wide_segment_vmem_bytes`` budget."""
    D = config.head_dim
    return (1 <= batch <= MAX_BATCH and live >= 1
            and wide_segment_smem_bytes(config, batch, live, dtype) <= MAX_SHARED_BYTES
            and config.embed_dim % 16 == 0 and D % 8 == 0 and D <= 128
            and KERNEL_THREADS % D == 0)


def decode_segment_wide_reference(packed, kv_state, carry, prompts, plens, starts, step0: int,
                                  seed: int, temps, topk, topp, *, config, steps: int,
                                  cache_len: int, live: int):
    """The plain PyTorch version of the kernel (same contract as
    ``decode_segment_wide``, with the sampling values already ``(B,)``
    float32 sentinel vectors of ``row_params`` and the per-row inputs int32
    tensors). Numerics as ``decode_wide_reference``: matmul operands
    rounded to the activation dtype (bf16 for int8 weights) with the int8
    scale on the product, q rounded, scores, softmax and the AV product in
    float32. Updates ``kv_state`` and ``carry`` in place and returns the
    ``(B, steps)`` tokens."""
    device = packed["wte"].device
    act = packed["wte"].dtype
    B, P = prompts.shape
    L, H, D, E = config.num_layers, config.num_heads, config.head_dim, config.embed_dim
    W, eps = config.window_size, config.layer_norm_epsilon
    live = min(live, cache_len)
    prompts, plens, starts = prompts.long(), plens.long(), starts.long()
    if bool(((plens < 1) | (plens > P)).any()):
        raise ValueError(f"prompt lengths must lie in [1, {P}]")
    use_filters = bool(((topk < packed["wte"].shape[0]) | (topp < 1)).any())
    w32 = {name: packed[name].float() for name in (
        "big_w", "fp_w", "wte", "logits_w", "wpe", "rel_rows")}
    wscale, fpscale = packed.get("wscale"), packed.get("fpscale")
    logits_b = _logits_bias(packed, config)
    scale = float(D) ** -0.5 if config.scale_attention else 1.0
    rows = torch.arange(B, device=device)
    slots = torch.arange(live, device=device)

    def mm(x, w, s=None):
        out = x.to(act).float() @ w.t()
        return out if s is None else out * s

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
        # Row b's key j sits at distance key_pos[b] - j: relative-table row
        # W-1-(key_pos-j), no bias outside the table; keys past key_pos masked.
        band_row = W - 1 - (key_pos[:, None] - slots[None, :])  # (B, live)
        band_index = band_row.clamp(0, W - 1)[:, None, :].expand(B, H, live)
        masked = slots[None, None, :] > key_pos[:, None, None]
        for layer in range(L):
            big = w32["big_w"][layer]
            s_big = wscale[layer] if wscale is not None else None
            ln1 = packed["ln1"][layer]
            x1 = _standardize(h, eps) * ln1[0] + ln1[1]
            qkv = mm(x1, big[:3 * E], None if s_big is None else s_big[:3 * E]) \
                + packed["qkv_b"][layer]
            q, k, v = qkv[:, :E], qkv[:, E:2 * E], qkv[:, 2 * E:]
            kv_state[layer, 0, written, key_pos[written]] = k[written].to(act)
            kv_state[layer, 1, written, key_pos[written]] = v[written].to(act)
            qh = q.to(act).float().reshape(B, H, D)
            keys = kv_state[layer, 0, :, :live].float().reshape(B, live, H, D)
            scores = torch.einsum("bhd,bjhd->bhj", qh, keys)
            if config.use_relative_attention:
                table = w32["rel_rows"][layer].reshape(W, H, D)
                bias = torch.einsum("bhd,whd->bhw", qh, table).gather(2, band_index)
                scores = scores + torch.where(band_row[:, None, :] >= 0, bias, 0.0)
            scores = torch.where(masked, NEG_INF, scores * scale)
            p = torch.exp(scores - scores.max(dim=-1, keepdim=True).values)
            values = kv_state[layer, 1, :, :live].float().reshape(B, live, H, D)
            mixed = torch.einsum("bhj,bjhd->bhd", p, values)
            attn = (mixed / p.sum(-1, keepdim=True)).reshape(B, E)
            x2 = x1 + (mm(attn, big[3 * E:4 * E], None if s_big is None else s_big[3 * E:4 * E])
                       + packed["proj_b"][layer])
            hidden = _gelu_tanh(mm(_standardize(x2, eps), big[4 * E:],
                                   None if s_big is None else s_big[4 * E:])
                                + packed["fc_b"][layer])
            h = x2 + mm(hidden, w32["fp_w"][layer],
                        None if fpscale is None else fpscale[layer]) + packed["fp_b"][layer]
        logits = mm(_standardize(h, eps), w32["logits_w"]) + logits_b
        sample = dk.sample_rows(logits, temps, topk, topp, seed, i, use_filters)
        tokens[:, j] = torch.where(active, sample, -1).to(torch.int32)
        token = torch.where(pos + 1 < plens, prompt_at(pos + 1), sample)
    carry.copy_(token)
    return tokens


def _check_inputs(packed, kv_state, carry, prompts, plens, starts, config, cache_len, steps,
                  live):
    _check_packed(packed, config)
    B = prompts.shape[0]
    act = packed["wte"].dtype
    shape = (config.num_layers, 2, B, cache_len, config.embed_dim)
    if not isinstance(kv_state, torch.Tensor) or tuple(kv_state.shape) != shape \
            or kv_state.dtype != act:
        raise ValueError(f"kv_state must be a {shape} {act} tensor (init_wide_segment_state "
                         "with the same batch and cache_len)")
    if carry.shape != (B,) or carry.dtype != torch.int32 or carry.device != kv_state.device:
        raise ValueError(f"carry must be a ({B},) int32 tensor beside kv_state")
    if plens.shape != (B,) or starts.shape != (B,) or steps < 1 or live < 1:
        raise ValueError("plens and starts must be (B,), steps and live positive")


def decode_segment_wide(packed, kv_state, carry, prompts, plens, starts, step0: int,
                        seed: int, temperature, top_k, top_p, *, config, steps: int,
                        cache_len: int, live: int, greedy=None, use_k=None, use_p=None,
                        grid: int = 0, phase_ns=None):
    """Runs decode steps ``[step0, step0 + steps)`` over the slot batch with
    the weights of ``pack_weights_wide`` (float32, bf16 or int8).

    ``kv_state`` ``(L, 2, B, cache_len, E)`` and ``carry`` ``(B,)`` int32 come
    from ``init_wide_segment_state``. ``prompts (B, P)``, ``plens (B,)`` in
    [1, P] and ``starts (B,)`` (``PARKED`` for an empty slot) are host arrays
    or tensors; ``temperature``/``top_k``/``top_p`` host scalars or per-row
    vectors (``greedy``/``use_k``/``use_p`` as in the JAX package). ``live``
    bounds the cache rows attention reads: a row whose position reaches it
    attends to ``[0, live)`` and writes nothing. ``grid`` is the number of
    blocks (0: one per SM); a grid that cannot be resident at once is
    refused. ``phase_ns`` (optional ``(len(PHASES),)`` int64 on the card)
    accumulates block 0's clock, as in ``decode_wide``.

    Returns ``(tokens, kv_state, carry)``: tokens ``(B, steps)`` int32, row
    s's raw sample after each step, -1 while parked; the state is updated in
    place. On CPU tensors this is the plain version; on CUDA tensors it
    launches the kernel (counted in ``decode_segment_wide.launches``) or
    raises.
    """
    device = packed["wte"].device
    B = prompts.shape[0]
    vpad = packed["wte"].shape[0]
    live = min(int(live), cache_len)
    if not (isinstance(plens, torch.Tensor) and plens.is_cuda):
        # Checked on the host: reading a card tensor here would wait for the
        # segment in flight. The kernel clamps a length into [1, P].
        host = np.asarray(plens.cpu() if isinstance(plens, torch.Tensor) else plens)
        if host.size and (host.min() < 1 or host.max() > prompts.shape[1]):
            raise ValueError(f"prompt lengths must lie in [1, {prompts.shape[1]}]")
    greedy, use_k, use_p = dk.sampling_flags(temperature, top_k, top_p, greedy, use_k, use_p)
    rows = dk.row_params(B, vpad, temperature, top_k, top_p, greedy, use_k, use_p, "cpu")
    temps, topk, topp = (_upload(t, torch.float32, device) for t in rows)
    prompts, plens, starts = (_upload(t, torch.int32, device) for t in (prompts, plens, starts))
    _check_inputs(packed, kv_state, carry, prompts, plens, starts, config, cache_len, steps,
                  live)
    kwargs = dict(config=config, steps=steps, cache_len=cache_len, live=live)
    if device.type == "cpu":
        tokens = decode_segment_wide_reference(packed, kv_state, carry, prompts, plens, starts,
                                               step0, seed, temps, topk, topp, **kwargs)
        return tokens, kv_state, carry
    if device.type != "cuda":
        raise ValueError(f"decode_segment_wide runs on CPU or CUDA tensors, not {device}")
    if phase_ns is not None and (phase_ns.device != device or phase_ns.dtype != torch.int64
                                 or phase_ns.shape != (len(PHASES),)):
        raise ValueError(f"phase_ns must be a ({len(PHASES)},) int64 tensor on {device}")
    wdtype = packed["big_w"].dtype
    if not wide_segment_kernel_fits(config, B, live, wdtype):
        raise ValueError(
            f"the kernel takes 1..{MAX_BATCH} slots, embed % 16 == 0, head_dim % 8 == 0 up to "
            f"128 dividing {KERNEL_THREADS}, and at most {MAX_SHARED_BYTES} bytes of shared "
            f"memory; {B} slots need {wide_segment_smem_bytes(config, B, live, wdtype)}")
    import ctypes

    from composer_tpu_torch.ops._build import load_library

    tokens = torch.empty((B, steps), dtype=torch.int32, device=device)
    # Zeroed: the split counters and the grid barrier's counter start at 0.
    scratch = torch.zeros(_scratch_floats(B, config), dtype=torch.float32, device=device)
    inputs = {name: packed.get(name) for name in (
        "big_w", "fp_w", "wscale", "fpscale", "wte", "logits_w", "wpe", "ln1", "qkv_b",
        "proj_b", "fc_b", "fp_b")}
    inputs.update(logits_b=_logits_bias(packed, config), rel_rows=packed["rel_rows"],
                  kv=kv_state, carry=carry, prompts=prompts, plens=plens, starts=starts,
                  temps=temps, topk=topk, topp=topp, tokens=tokens, scratch=scratch)
    # The weights' and the cache's dtypes were checked by _check_inputs.
    _check_cuda_tensors(inputs, device, ("big_w", "fp_w", "wte", "logits_w", "wpe", "rel_rows",
                                         "kv"), ("carry", "prompts", "plens", "starts", "tokens"))

    lib = load_library("decode_wide_segment")
    ptr = ctypes.c_void_p
    err = lib.decode_wide_segment(
        ctypes.c_int(_WEIGHT_KINDS[packed["big_w"].dtype]),
        ctypes.c_int(device.index if device.index is not None else torch.cuda.current_device()),
        ctypes.c_int(grid),
        *(ptr(inputs[name].data_ptr() if inputs[name] is not None else 0) for name in (
            "big_w", "fp_w", "wscale", "fpscale", "wte", "logits_w", "wpe", "ln1", "qkv_b",
            "proj_b", "fc_b", "fp_b", "logits_b", "rel_rows", "kv", "carry", "prompts",
            "plens", "starts", "temps", "topk", "topp", "tokens", "scratch")),
        ptr(phase_ns.data_ptr() if phase_ns is not None else 0),
        *(ctypes.c_int(int(v)) for v in (
            scratch.numel(), B, prompts.shape[1], config.num_layers, config.num_heads,
            config.head_dim, config.embed_dim, cache_len, config.window_size, vpad, step0,
            steps, live, config.use_relative_attention)),
        ctypes.c_uint(int(seed) & 0xFFFFFFFF),
        ctypes.c_float(float(config.head_dim) ** -0.5 if config.scale_attention else 1.0),
        ctypes.c_float(config.layer_norm_epsilon),
        ptr(torch.cuda.current_stream(device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"decode_wide_segment kernel launch failed: CUDA error {err}")
    decode_segment_wide.launches += 1
    return tokens, kv_state, carry


decode_segment_wide.launches = 0
