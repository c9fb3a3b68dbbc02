"""Batched fused decoding: B sequences in one generation loop on the GPU.

Port of ``composer_tpu/ops/decode_kernel_batched.py``. The Hopper kernel
``decode_generate`` (``csrc/decode_generate.cu``, CUDA C++ for ``sm_90a``)
replaces both TPU kernels of the decode path:

* ``composer_tpu/ops/decode_kernel_batched.py::_batched_kernel`` (B > 1);
* ``composer_tpu/ops/decode_kernel.py::_decode_kernel`` (B = 1).

Design. One thread-block cluster per sequence: ``cluster_size`` blocks
(G) on G SMs of one GPC, exchanging activations through distributed shared
memory; the sequences share only the weights, so no grid-wide
synchronisation is needed. Each cluster loops over every step and layer in
the kernel, as the TPU kernel does: embedding, 8 pre-LN layers with the KV
append, attention with the relative bias, tied logits, temperature, top-k /
top-p, Gumbel-max and token feedback. Block g owns H/G heads and a 1/G slice
of every matmul's columns (``csrc/decode_cluster.cuh``). The KV cache lives
in device memory in the ``(L, B*C, E)`` layout that
``cache_to_rows_batched`` exports, so a prefilled cache feeds it unchanged.
The random bits come from a Philox4x32-10 written into the kernel and keyed
by (seed, row, step, vocab lane); ``gumbel_noise`` draws the same bits, so
the kernel and ``decode_generate_reference`` sample identical ids. Every sum
is taken in the one-block kernel's order, set by the model's widths alone:
the ids equal that kernel's bit for bit and do not depend on G, so not on
the batch a row runs in.

What bounds it on the H100: every step each cluster reads all packed weights
(about 12.6 MB in bf16 for the default model) from L2, 12.6/G MB a block,
and its row's K/V prefix; B x G of the 132 SMs work. The attention scores
(``H/G x C`` float32) live in shared memory; caches are admitted by the
budget of the one-block layout, which every G fits (``kernel_fits``).
``wgmma`` and TMA are later work.
"""

from __future__ import annotations

import numpy as np
import torch

from composer_tpu_torch.ops.decode_kernel import (
    NEG_INF,
    row_params,
    sample_rows,
    sampling_flags,
    vocab_pad,
)

# Threads per block; must match kThreads in csrc/decode_common.cuh.
KERNEL_THREADS = 512
# Shared memory one block may use on Hopper (227 KB), static and dynamic
# together.
MAX_SHARED_BYTES = 232448
# kStaticSharedBytes in csrc/decode_generate.cu: s_token, padded to the
# 16-byte boundary where the dynamic buffer starts.
STATIC_SHARED_BYTES = 16


# Cluster sizes the resident decode kernels take, largest first; the first
# must match kMaxCluster in csrc/decode_cluster.cuh.
CLUSTER_SIZES = (16, 8, 4, 2)


def cluster_size(batch: int, heads: int, sm_count: int, max_active) -> int:
    """Blocks G of the cluster that runs one sequence (or serving slot) in
    ``decode_generate`` and ``decode_segment``: the largest of
    ``CLUSTER_SIZES`` that divides ``heads``, keeps ``batch * G`` within
    ``sm_count`` and lets all ``batch`` clusters be resident at once, where
    ``max_active[G]`` is the count of G-block clusters the card can hold
    (``cudaOccupancyMaxActiveClusters`` for the kernel and its shared
    memory); 1, the one-block layout, when none does. A pure function of its
    arguments: there is no other setting."""
    for g in CLUSTER_SIZES:
        if heads % g == 0 and batch * g <= sm_count and max_active.get(g, 0) >= batch:
            return g
    return 1


_MAX_ACTIVE: dict = {}


def launch_cluster_size(library: str, config, batch: int, keys: int, wdtype, device,
                        extra=None) -> int:
    """``cluster_size`` for a launch of ``library``'s kernel (``decode_generate``,
    ``decode_segment`` or ``spec_decode``) on ``device``, with ``max_active``
    queried from the card once per kernel type, widths and ``keys`` (score
    slots per head). ``extra(g)`` gives the query's further int arguments at
    G = g (the speculative kernel's block and passes), or None where the
    kernel cannot run at g, which then counts no resident cluster."""
    import ctypes

    from composer_tpu_torch.ops._build import load_library

    index = device.index if device.index is not None else torch.cuda.current_device()
    bf16 = 1 if wdtype == torch.bfloat16 else 0
    sizes = [g for g in CLUSTER_SIZES if config.num_heads % g == 0]
    more = {g: extra(g) if extra is not None else () for g in sizes}
    widths = (config.embed_dim, config.num_heads, config.head_dim, keys, vocab_pad(config))
    key = (library, bf16, index, *widths, tuple(more.items()))
    max_active = _MAX_ACTIVE.get(key)
    if max_active is None:
        query = getattr(load_library(library), f"{library}_clusters")
        max_active = {}
        for g in sizes:
            if more[g] is None:
                max_active[g] = 0
                continue
            count = ctypes.c_int(0)
            err = query(bf16, index, g, *widths, *more[g], ctypes.byref(count))
            if err != 0:
                raise RuntimeError(f"{library}: cluster occupancy query failed for G={g}: "
                                   f"CUDA error {err}")
            max_active[g] = count.value
        _MAX_ACTIVE[key] = max_active
    sm_count = torch.cuda.get_device_properties(index).multi_processor_count
    return cluster_size(batch, config.num_heads, sm_count, max_active)


def kernel_smem_bytes(config, cache_len: int) -> int:
    """The shared-memory budget a cache is admitted by, static and dynamic:
    the one-block layout's (``budget_floats`` in csrc/decode_cluster.cuh,
    ``cache_len`` score slots per head), which a block of any cluster size
    fits."""
    floats = (64 + 11 * config.embed_dim + 4 * vocab_pad(config) + config.num_heads * cache_len
              + KERNEL_THREADS * 8)
    return 4 * floats + STATIC_SHARED_BYTES


def kernel_fits(config, cache_len: int) -> bool:
    """The kernel's limits: the ``H x cache_len`` float32 scores plus the
    per-block activations of the one-block layout must fit 227 KB of shared
    memory (for the default model, cache_len <= 3067; a block of a larger
    cluster holds H/G score rows and fits too), and head_dim must be a
    multiple of 8 (16-byte loads of a head's lanes)."""
    return (kernel_smem_bytes(config, cache_len) <= MAX_SHARED_BYTES
            and config.head_dim % 8 == 0)


def _logits_bias(packed, config):
    """ln_f's folded beta, with NEG_INF on the vocabulary-padding lanes."""
    vpad = packed["wte"].shape[0]
    lanes = torch.arange(vpad, device=packed["wte"].device)[None, :]
    mask = torch.where(lanes < config.vocab_size, 0.0, NEG_INF)
    return (packed["logits_b"].float() + mask).contiguous()


def _standardize(x, eps):
    mean = x.mean(-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(-1, keepdim=True)
    return centered * torch.rsqrt(var + eps)


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))


def decode_generate_reference(packed, prompts, plens, seed, temps, topk, topp, k_rows,
                              v_rows, *, config, num_steps: int, out_len: int,
                              cache_len: int, start_step: int, logits_out=None):
    """The plain PyTorch version of the fused loop (same contract as
    ``decode_generate``). Matmul operands are cast to the weight dtype and
    accumulated in float32; q is cast to the KV dtype before the scores and
    the softmax weights to the V dtype before the AV product."""
    device = packed["wte"].device
    wdtype = packed["wte"].dtype
    B = prompts.shape[0]
    # Rows whose filters are off carry the sentinels; skip the sort if all do.
    use_filters = bool(((topk < packed["wte"].shape[0]) | (topp < 1)).any())
    L, H, D, E = config.num_layers, config.num_heads, config.head_dim, config.embed_dim
    C, W, eps = cache_len, config.window_size, config.layer_norm_epsilon
    w32 = {name: packed[name].float() for name in (
        "wte", "wte_t", "wpe", "qkv_w", "proj_w", "fc_w", "fp_w", "rel_rows")}
    logits_b = _logits_bias(packed, config)
    scale = float(D) ** -0.5 if config.scale_attention else 1.0

    def mm(x, w):
        return x.to(wdtype).float() @ w

    def cache(rows):
        if rows is None:
            return torch.zeros((L, B, C, E), dtype=wdtype, device=device)
        return rows.to(wdtype).reshape(L, B, C, E).clone()

    kc, vc = cache(k_rows), cache(v_rows)
    prompts = prompts.long()
    plens = plens.long()
    rows = torch.arange(B, device=device)
    slots = torch.arange(C, device=device)
    tokens = torch.zeros((B, out_len), dtype=torch.int32, device=device)
    token = prompts[:, start_step]

    for pos in range(start_step, num_steps):
        h = w32["wte"][token] + w32["wpe"][min(pos, W - 1)]
        for layer in range(L):
            ln1 = packed["ln1"][layer]
            x1 = _standardize(h, eps) * ln1[0] + ln1[1]
            qkv = mm(x1, w32["qkv_w"][layer]) + packed["qkv_b"][layer]
            q, k, v = qkv[:, :E], qkv[:, E:2 * E], qkv[:, 2 * E:]
            kc[layer, :, pos] = k.to(wdtype)
            vc[layer, :, pos] = v.to(wdtype)
            qw = q.to(wdtype).float().reshape(B, H, D)
            scores = torch.einsum("bhd,bchd->bhc", qw, kc[layer].float().reshape(B, C, H, D))
            if config.use_relative_attention:
                r = W - 1 - (pos - slots)
                valid = (r >= 0) & (r < W)
                band = w32["rel_rows"][layer][r.clamp(0, W - 1)] * valid[:, None]
                scores = scores + torch.einsum("bhd,chd->bhc", qw, band.reshape(C, H, D))
            scores = torch.where(slots <= pos, scores * scale, NEG_INF)
            p = torch.exp(scores - scores.max(dim=-1, keepdim=True).values)
            weights = (p / p.sum(-1, keepdim=True)).to(wdtype).float()
            attn = torch.einsum("bhc,bchd->bhd", weights,
                                vc[layer].float().reshape(B, C, H, D)).reshape(B, E)
            x2 = x1 + (mm(attn, w32["proj_w"][layer]) + packed["proj_b"][layer])
            hidden = _gelu_tanh(mm(_standardize(x2, eps), w32["fc_w"][layer])
                                + packed["fc_b"][layer])
            h = x2 + mm(hidden, w32["fp_w"][layer]) + packed["fp_b"][layer]
        logits = mm(_standardize(h, eps), w32["wte_t"]) + logits_b  # (B, Vpad)
        if logits_out is not None and pos == num_steps - 1:
            logits_out.copy_(logits)

        next_token = sample_rows(logits, temps, topk, topp, seed, pos, use_filters)

        col = pos - plens + 1
        hit = (col >= 0) & (col < out_len)
        tokens[rows[hit], col[hit]] = next_token[hit].to(torch.int32)
        forced = prompts[:, min(pos + 1, prompts.shape[1] - 1)]
        token = torch.where(pos + 1 < plens, forced, next_token)
    return tokens


_WEIGHT_NAMES = ("wte", "wte_t", "wpe", "qkv_w", "proj_w", "fc_w", "fp_w", "rel_rows",
                 "kcache", "vcache")


def _check_cuda_inputs(tensors, device, wdtype):
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            # The kernel reads rows with 16-byte vector loads.
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        expected = wdtype if name in _WEIGHT_NAMES else (
            torch.int32 if name in ("prompts", "plens", "starts") else torch.float32)
        if t.dtype != expected:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {expected}")


def decode_generate(packed, prompts, plens, seed, temps, topk, topp, k_rows, v_rows,
                    *, config, num_steps: int, out_len: int, cache_len: int,
                    start_step: int, logits_out=None):
    """Runs the fused loop for steps ``[start_step, num_steps)``.

    prompts ``(B, P)`` and plens ``(B,)`` int32; temps, topk, topp ``(B,)``
    float32 with the filter sentinels (``row_params``); k_rows / v_rows
    ``(L, B*cache_len, E)`` prefilled rows or None. Returns ``(B, out_len)``
    int32 ids: row s's sample at step i lands in column ``i - plens[s] + 1``.
    ``logits_out`` (optional ``(B, Vpad)`` float32) receives the last step's
    logits.

    On CPU tensors this is the plain version. On CUDA tensors it launches the
    kernel as B clusters of ``cluster_size`` blocks (G, kept in
    ``decode_generate.cluster``; counted in ``decode_generate.launches_batched``
    for B > 1 and ``decode_generate.launches_single`` for B = 1) or raises.
    """
    device = packed["wte"].device
    if device.type == "cpu":
        return decode_generate_reference(
            packed, prompts, plens, seed, temps, topk, topp, k_rows, v_rows,
            config=config, num_steps=num_steps, out_len=out_len, cache_len=cache_len,
            start_step=start_step, logits_out=logits_out,
        )
    if device.type != "cuda":
        raise ValueError(f"decode_generate runs on CPU or CUDA tensors, not {device}")
    if not kernel_fits(config, cache_len):
        raise ValueError(
            f"the kernel takes head_dim % 8 == 0 and at most {MAX_SHARED_BYTES} bytes of "
            f"shared memory; cache_len {cache_len} needs "
            f"{kernel_smem_bytes(config, cache_len)}, head_dim is {config.head_dim}"
        )
    import ctypes

    from composer_tpu_torch.ops._build import load_library

    B = prompts.shape[0]
    L, E = config.num_layers, config.embed_dim
    wdtype = packed["wte"].dtype
    if wdtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes float32 or bfloat16 weights, not {wdtype}")

    def cache(rows):
        if rows is None:
            return torch.zeros((L, B * cache_len, E), dtype=wdtype, device=device)
        if rows.shape != (L, B * cache_len, E):
            raise ValueError(f"prefill rows {tuple(rows.shape)} != {(L, B * cache_len, E)}")
        return rows.to(wdtype).contiguous().clone()

    kcache, vcache = cache(k_rows), cache(v_rows)
    tokens = torch.zeros((B, out_len), dtype=torch.int32, device=device)
    logits_b = _logits_bias(packed, config)
    inputs = {name: packed[name] for name in (
        "wte", "wte_t", "wpe", "ln1", "qkv_w", "qkv_b", "proj_w", "proj_b",
        "fc_w", "fc_b", "fp_w", "fp_b", "rel_rows")}
    inputs.update(logits_b=logits_b, kcache=kcache, vcache=vcache,
                  prompts=prompts, plens=plens, temps=temps, topk=topk, topp=topp)
    _check_cuda_inputs(inputs, device, wdtype)
    if logits_out is not None:
        _check_cuda_inputs({"logits_out": logits_out}, device, wdtype)
    if not 0 <= start_step < int(plens.min()) or int(plens.max()) > prompts.shape[1]:
        raise ValueError("need 0 <= start_step < min(plens) and max(plens) <= prompt width")
    if num_steps > cache_len or out_len < 1:
        raise ValueError(f"num_steps {num_steps} exceeds cache_len {cache_len}, or no output")
    vpad = packed["wte"].shape[0]
    if any(t.shape != (B,) for t in (plens, temps, topk, topp)) or (
            logits_out is not None and logits_out.shape != (B, vpad)):
        raise ValueError("per-row inputs must be (B,) and logits_out (B, Vpad)")
    if packed["wte_t"].shape != (E, vpad) or packed["qkv_w"].shape != (L, E, 3 * E):
        raise ValueError("packed weights do not match the config")
    if config.use_relative_attention and packed["rel_rows"].shape[1] != config.window_size:
        raise ValueError("rel_rows must hold window_size rows with relative attention on")

    lib = load_library()
    cluster = launch_cluster_size("decode_generate", config, B, cache_len, wdtype, device)
    ptr = ctypes.c_void_p
    err = lib.decode_generate(
        ctypes.c_int(1 if wdtype == torch.bfloat16 else 0),
        ctypes.c_int(device.index if device.index is not None else torch.cuda.current_device()),
        *(ptr(inputs[name].data_ptr()) for name in (
            "wte", "wte_t", "wpe", "ln1", "qkv_w", "qkv_b", "proj_w", "proj_b",
            "fc_w", "fc_b", "fp_w", "fp_b", "logits_b", "rel_rows", "kcache", "vcache",
            "prompts", "plens", "temps", "topk", "topp")),
        ptr(tokens.data_ptr()),
        ptr(logits_out.data_ptr() if logits_out is not None else 0),
        *(ctypes.c_int(int(v)) for v in (
            B, prompts.shape[1], L, config.num_heads, config.head_dim, E, cache_len,
            config.window_size, vpad, num_steps, start_step, out_len,
            config.use_relative_attention)),
        ctypes.c_uint(int(seed) & 0xFFFFFFFF),
        ctypes.c_float(float(config.head_dim) ** -0.5 if config.scale_attention else 1.0),
        ctypes.c_float(config.layer_norm_epsilon),
        ctypes.c_int(cluster),
        ptr(torch.cuda.current_stream(device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"decode_generate kernel launch failed (cluster {cluster}): "
                           f"CUDA error {err}")
    decode_generate.cluster = cluster
    if B > 1:
        decode_generate.launches_batched += 1
    else:
        decode_generate.launches_single += 1
    return tokens


decode_generate.launches_batched = 0
decode_generate.launches_single = 0
decode_generate.cluster = None  # G of the last launch


def megakernel_generate_batched(packed, prompts, seed, temperature, *, config,
                                length: int, cache_len: int, top_k=0, top_p=0.0,
                                greedy=None, use_k=None, use_p=None,
                                prompt_lengths=None, prefill_rows=None,
                                start_step: int = 0):
    """Generates ``length`` ids for each of B prompts in one kernel launch.

    prompts: ``(B, P)`` ids. ``prompt_lengths`` (a ``(B,)`` vector, each in
    [1, P]) makes the prompts ragged: row s is teacher-forced only through
    its own prefix, and its ids still occupy output columns ``[0, length)``.
    ``temperature``/``top_k``/``top_p`` are scalars or per-row vectors; a
    row with temperature <= 0 decodes greedily inside a sampled batch.

    ``prefill_rows`` = (k_rows, v_rows), each ``(L, B*cache_len, E)``, holds
    the cache of positions ``[0, start_step)`` from one batched forward
    (``cache_to_rows_batched``); the loop then starts at ``start_step``.
    Greedy ids are identical with or without the prefill.
    """
    device = packed["wte"].device
    prompts = torch.as_tensor(prompts, dtype=torch.int32).to(device).contiguous()
    batch, width = prompts.shape
    if width + length > cache_len:
        raise ValueError("prompt + length exceeds cache")
    ragged = prompt_lengths is not None
    if ragged:
        plens = np.asarray(prompt_lengths, np.int32).reshape(-1)
        if plens.shape[0] != batch:
            raise ValueError(
                f"prompt_lengths has {plens.shape[0]} rows for a batch of {batch}"
            )
        if plens.min() < 1 or plens.max() > width:
            raise ValueError(
                f"prompt_lengths must lie in [1, {width}], got [{plens.min()}, {plens.max()}]"
            )
    else:
        plens = np.full(batch, width, np.int32)
    greedy, use_k, use_p = sampling_flags(temperature, top_k, top_p, greedy, use_k, use_p)
    if start_step:
        if prefill_rows is None:
            raise ValueError("start_step > 0 requires prefill_rows")
        if start_step >= plens.min():
            # The input at step start_step must still be a forced prompt
            # token for every row: the prefill never samples.
            raise ValueError(
                f"start_step ({start_step}) must be < min prompt length ({plens.min()})"
            )
        k_rows, v_rows = prefill_rows
        expected = (config.num_layers, batch * cache_len, config.embed_dim)
        if tuple(k_rows.shape) != expected:
            raise ValueError(f"prefill k_rows shape {tuple(k_rows.shape)} != {expected}")
    else:
        k_rows = v_rows = None
    temps, topk, topp = row_params(batch, packed["wte"].shape[0], temperature, top_k,
                                   top_p, greedy, use_k, use_p, device)
    num_steps = width + length - 1
    tokens = decode_generate(
        packed, prompts, torch.as_tensor(plens).to(device), seed, temps, topk, topp,
        k_rows, v_rows, config=config, num_steps=num_steps,
        out_len=num_steps if ragged else length, cache_len=cache_len,
        start_step=start_step,
    )
    return tokens[:, :length]
