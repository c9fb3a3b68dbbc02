"""Speculative block decoding at batch 1: n-gram-drafted tokens verified in
one forward pass per block.

Port of ``composer_tpu/ops/decode_kernel_spec.py``. The TPU kernel
``_spec_decode_kernel`` is replaced by the Hopper kernel ``spec_decode``
(``csrc/spec_decode.cu``, CUDA C++ for ``sm_90a``), whose header states how
it computes and what bounds it. One launch runs the whole generation on one
thread-block cluster of G blocks (``cluster_size`` at batch 1, as
``decode_generate`` takes it). Each verify block of ``T`` positions from
``p0``:

1. drafts ``T - 1`` tokens by suffix lookup: the latest ``j`` in
   ``[1, p0 - (T - 1)]`` whose 2-gram (falling back to the 1-gram) context
   matches the stream's tail; block input ``t`` is the prompt token inside
   the prompt (and at ``t = 0``), ``ids[j + t]`` after it;
2. runs one forward pass over the ``T`` rows, appending K and V for all of
   them: row ``t`` is ``decode_generate``'s step at position ``p0 + t``
   (``csrc/decode_cluster_rows.cuh``), each weight and K/V row loaded once
   for all rows;
3. samples every row; the draft is a point mass, so the sampled stream keeps
   ``s_t`` while the earlier samples equal their drafted successors: each
   block emits 1 to ``T`` tokens.

Row ``t`` draws the Gumbel noise of row 0 at step ``p0 + t``, the bits the
sequential kernel draws at that position, and its sums are taken in the
sequential kernel's order, so an emitted row's logits equal that kernel's:
greedy and sampled speculative ids equal ``decode_generate``'s at batch 1 bit
for bit, in float32 and bfloat16. The JAX kernel could promise only the same
distribution: its TPU PRNG draws ``T`` rows per block.

Beside the kernel: ``speculative_generate_reference``, the plain PyTorch
version; ``spec_decode``, the wrapper (a CPU tensor runs the plain version,
a CUDA tensor launches the kernel, counted in ``spec_decode.launches``, or
raises); ``speculative_generate``, the JAX entry point's signature without
``interpret``; ``spec_kernel_fits``, the shared-memory admission that
routing follows, and ``spec_cluster_passes``, how a cluster's blocks fit
what it admits.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from composer_tpu_torch.ops.decode_kernel import (
    NEG_INF,
    filtered_scaled_logits,
    first_argmax,
    gumbel_noise,
    row_params,
    sampling_flags,
    vocab_pad,
)
from composer_tpu_torch.ops.decode_kernel_batched import (
    KERNEL_THREADS,
    MAX_SHARED_BYTES,
    _check_cuda_inputs,
    _gelu_tanh,
    _logits_bias,
    _standardize,
    launch_cluster_size,
)

# Tokens advanced per verified block (1 real + T-1 drafted), as measured on
# the TPU (composer_tpu/ops/decode_kernel_spec.py:66-76); not re-swept on the
# H100 yet. COMPOSER_SPEC_BLOCK forces one size for both regimes.
SPEC_BLOCK_GREEDY = 5
SPEC_BLOCK_SAMPLED = 3
SPEC_BLOCK_MIN, SPEC_BLOCK_MAX = 2, 16  # kMaxRows in csrc/decode_cluster_rows.cuh
ROW_CHUNK = 8  # kRowChunk: rows one pass over a weight feeds
# kStaticSharedBytes: the block's input tokens, samples and match flag
# (132 bytes), padded to the 16-byte boundary where the dynamic buffer starts.
SPEC_STATIC_SHARED_BYTES = (4 * (2 * SPEC_BLOCK_MAX + 1) + 15) // 16 * 16
# kRowRed: floats of the LayerNorms' warp sums of up to 16 rows, twice.
ROW_RED = 2 * SPEC_BLOCK_MAX * (KERNEL_THREADS // 32)
# The phase kinds of a verify block that the kernel's optional clock times
# (``phase_ns``), in the order of csrc/spec_decode.cu and
# csrc/decode_cluster_rows.cuh; the layer phases summed over the layers.
PHASES = ("draft", "embedding + ln_1 + qkv", "scores", "softmax", "AV + share", "proj + share",
          "ln_2 + fc + share", "fp + share", "ln_f + logits + share", "sampling + emit")


def _parse_block_env():
    """Validate COMPOSER_SPEC_BLOCK: an integer in [2, 16] or unset."""
    raw = os.environ.get("COMPOSER_SPEC_BLOCK")
    if raw is None or raw == "":
        return None
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"COMPOSER_SPEC_BLOCK must be an integer in [2, 16], got {raw!r}"
        ) from None
    if value < SPEC_BLOCK_MIN or value > SPEC_BLOCK_MAX:
        raise ValueError(f"COMPOSER_SPEC_BLOCK must be in [2, 16], got {value}")
    return value


_SPEC_BLOCK_FORCED = _parse_block_env()


def default_block(greedy: bool) -> int:
    """The block size for a sampling regime (``COMPOSER_SPEC_BLOCK`` wins)."""
    if _SPEC_BLOCK_FORCED:
        return _SPEC_BLOCK_FORCED
    return SPEC_BLOCK_GREEDY if greedy else SPEC_BLOCK_SAMPLED


def spec_smem_bytes(config, cache_len: int, block: int) -> int:
    """The shared-memory budget a (cache, block) is admitted by, static and
    dynamic: the layout of the kernel's first, one-block design (an ``H x
    (cache_len + block)`` score row, ``block`` rows of activations and
    logits, the id stream, partial sums of 4 columns a thread). Routing
    follows it, so it stays as it was; every cluster size the launch takes
    fits what it admits (``spec_cluster_passes``). The id stream and the K/V
    rows span ``cache_len + block`` positions (the last block may run
    ``block - 1`` past the last token)."""
    E, H, V, T = config.embed_dim, config.num_heads, vocab_pad(config), block
    rows = cache_len + T
    floats = (64 + (rows + 3) // 4 * 4 + 7 * E * T + max(4 * E * T, KERNEL_THREADS * 8)
              + T * V + 3 * V
              + max(H * rows, min(T, ROW_CHUNK) * KERNEL_THREADS * 4))
    return 4 * floats + SPEC_STATIC_SHARED_BYTES


def spec_kernel_fits(config, cache_len: int, block: int) -> bool:
    """The kernel's admission: the budget of ``spec_smem_bytes`` within 227
    KB of shared memory (default model: block 3 up to cache_len 2671, block
    5 up to 2338, block 11 up to 1157; block 12 and above not at cache
    1024), head_dim a multiple of 8 and block in [2, 16]."""
    return (SPEC_BLOCK_MIN <= block <= SPEC_BLOCK_MAX
            and spec_smem_bytes(config, cache_len, block) <= MAX_SHARED_BYTES
            and config.head_dim % 8 == 0)


def _layout_splits(n: int) -> int:
    """``layout_splits``: a column's slices in 16-byte units of bf16."""
    groups = n // 8
    return 1 if groups >= KERNEL_THREADS else KERNEL_THREADS // groups


def _partial_floats(n: int, cols: int, rows: int) -> int:
    splits = _layout_splits(n)
    return 0 if splits == 1 else rows * splits * cols


def spec_cluster_smem_bytes(config, cache_len: int, block: int, cluster: int,
                            passes=None) -> int:
    """Shared memory of one block of a ``cluster``-block launch, static and
    dynamic; mirrors ``rows_smem_floats`` in csrc/decode_cluster_rows.cuh.
    ``passes`` = (heads per pass, rows per pass), by default
    ``spec_cluster_passes``' choice (the smallest layout where none fits)."""
    E, D, V, T, G = (config.embed_dim, config.head_dim, vocab_pad(config), block, cluster)
    keys = cache_len + T
    heads, rows = passes or spec_cluster_passes(config, cache_len, block, cluster) or (1, 1)
    partial = max(_partial_floats(n, n // G, rows) for n in (3 * E, E, 4 * E, V))
    scores = heads * T * keys + _partial_floats(E, heads * D, rows)
    floats = (ROW_RED + (keys + 3) // 4 * 4 + 5 * T * E + T * E // G + 4 * T * E + T * V
              + 3 * V + max(scores, partial))
    return 4 * floats + SPEC_STATIC_SHARED_BYTES


def spec_cluster_passes(config, cache_len: int, block: int, cluster: int):
    """``(heads_per_pass, rows_per_pass)`` of a launch on clusters of
    ``cluster`` blocks: the most rows a pass over the weights feeds (up to
    ``ROW_CHUNK``), then the most of a block's heads whose scores one pass
    holds, such that a block fits the card's shared memory; None where none
    does or ``cluster`` does not divide the heads and the padded vocabulary
    into 8-column groups. At cluster 16 the default model takes (1, min(block,
    8)) at every cache it admits."""
    H, T = config.num_heads, block
    if H % cluster or vocab_pad(config) % (8 * cluster):
        return None
    per_block = H // cluster
    for rows in range(min(T, ROW_CHUNK), 0, -1):
        for heads in range(per_block, 0, -1):
            if per_block % heads == 0 and spec_cluster_smem_bytes(
                    config, cache_len, block, cluster, (heads, rows)) <= MAX_SHARED_BYTES:
                return heads, rows
    return None


def draft_inputs(ids: np.ndarray, p0: int, plen: int, block: int) -> np.ndarray:
    """The input tokens of the block at ``p0`` (step 1 of the module
    docstring), from the id stream ``ids`` (positions past ``p0`` may hold
    rejected drafts or zeros)."""
    T = block
    cand = np.arange(1, p0 - (T - 1) + 1)
    j = 0
    if cand.size:
        eq1 = ids[cand] == ids[p0]
        eq2 = eq1 & (ids[cand - 1] == ids[p0 - 1])
        if eq2.any():
            j = int(cand[eq2][-1])
        elif eq1.any():
            j = int(cand[eq1][-1])
    t = np.arange(T)
    return np.where((p0 + t < plen) | (t == 0), ids[p0 + t], ids[j + t])


def _float_weights(packed) -> dict:
    return {name: packed[name].float() for name in (
        "wte", "wte_t", "wpe", "qkv_w", "proj_w", "fc_w", "fp_w", "rel_rows")}


def _block_logits(packed, w32, config, kc, vc, in_tok, p0: int):
    """One verify block's forward in the kernel's numerics: the rows of
    ``in_tok`` at positions ``p0 ..``, appending their K and V to ``kc`` /
    ``vc`` (``(L, rows, E)`` in the weight type) and attending over slots
    ``[0, position]``. Returns ``(T, Vpad)`` float32 logits."""
    device = packed["wte"].device
    wdtype = packed["wte"].dtype
    L, H, D, E = config.num_layers, config.num_heads, config.head_dim, config.embed_dim
    W, eps = config.window_size, config.layer_norm_epsilon
    scale = float(D) ** -0.5 if config.scale_attention else 1.0
    T = len(in_tok)

    def mm(x, w):
        return x.to(wdtype).float() @ w

    pos = p0 + torch.arange(T, device=device)  # (T,)
    n = p0 + T
    slots = torch.arange(n, device=device)
    h = w32["wte"][torch.as_tensor(in_tok, device=device)] + w32["wpe"][pos.clamp(max=W - 1)]
    for layer in range(L):
        ln1 = packed["ln1"][layer]
        x1 = _standardize(h, eps) * ln1[0] + ln1[1]
        qkv = mm(x1, w32["qkv_w"][layer]) + packed["qkv_b"][layer]
        q, k, v = qkv[:, :E], qkv[:, E:2 * E], qkv[:, 2 * E:]
        kc[layer, p0:n] = k.to(wdtype)
        vc[layer, p0:n] = v.to(wdtype)
        qw = q.to(wdtype).float().reshape(T, H, D)
        keys = kc[layer, :n].float().reshape(n, H, D)
        scores = torch.einsum("thd,chd->thc", qw, keys)
        if config.use_relative_attention:
            r = W - 1 - (pos[:, None] - slots[None, :])  # (T, n)
            valid = (r >= 0) & (r < W)
            band = w32["rel_rows"][layer][r.clamp(0, W - 1)] * valid[..., None]
            scores = scores + torch.einsum("thd,tchd->thc", qw, band.reshape(T, n, H, D))
        causal = (slots[None, :] <= pos[:, None])[:, None, :]  # (T, 1, n)
        scores = torch.where(causal, scores * scale, NEG_INF)
        p = torch.exp(scores - scores.max(dim=-1, keepdim=True).values)
        weights = (p / p.sum(-1, keepdim=True)).to(wdtype).float()
        attn = torch.einsum("thc,chd->thd", weights,
                            vc[layer, :n].float().reshape(n, H, D)).reshape(T, E)
        x2 = x1 + (mm(attn, w32["proj_w"][layer]) + packed["proj_b"][layer])
        hidden = _gelu_tanh(mm(_standardize(x2, eps), w32["fc_w"][layer])
                            + packed["fc_b"][layer])
        h = x2 + mm(hidden, w32["fp_w"][layer]) + packed["fp_b"][layer]
    return mm(_standardize(h, eps), w32["wte_t"]) + _logits_bias(packed, config)


def teacher_forced_logits(packed, ids, *, config):
    """The plain version's logits at every position of the stream ``ids``
    (``(n,)``), in one block: row ``p`` scores the token after position
    ``p``. A speculative run's emitted tokens are its own stream, so feeding
    it back shows what the plain version scores at each emitted position.
    Returns ``(n, Vpad)`` float32 on the weights' device."""
    ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids, np.int64).reshape(-1)
    L, E = config.num_layers, config.embed_dim
    device, wdtype = packed["wte"].device, packed["wte"].dtype
    kc = torch.zeros((L, len(ids), E), dtype=wdtype, device=device)
    vc = torch.zeros_like(kc)
    return _block_logits(packed, _float_weights(packed), config, kc, vc, ids, 0)


def speculative_generate_reference(packed, prompt, seed: int, temp: float, topk: float,
                                   topp: float, *, config, length: int, cache_len: int,
                                   block: int):
    """The plain PyTorch version of the kernel (same contract as
    ``spec_decode``): ``(tokens (length,), stats (8,))`` int32 on the weights'
    device. ``temp <= 0`` is greedy; ``topk``/``topp`` carry the filter
    sentinels of ``row_params``. Numerics as ``decode_generate_reference``."""
    device = packed["wte"].device
    wdtype = packed["wte"].dtype
    prompt = np.asarray(prompt.cpu() if isinstance(prompt, torch.Tensor) else prompt,
                        np.int64).reshape(-1)
    plen, T = prompt.shape[0], block
    L, E = config.num_layers, config.embed_dim
    rows = cache_len + T
    w32 = _float_weights(packed)
    vpad = packed["wte"].shape[0]
    greedy = not temp > 0
    temps = torch.full((T,), float(temp), dtype=torch.float32, device=device)
    topks = torch.full((T,), float(topk), dtype=torch.float32, device=device)
    topps = torch.full((T,), float(topp), dtype=torch.float32, device=device)
    use_filters = topk < vpad or topp < 1

    kc = torch.zeros((L, rows, E), dtype=wdtype, device=device)
    vc = torch.zeros((L, rows, E), dtype=wdtype, device=device)
    # Positions past the prompt start as zeros, as in the TPU kernel's id
    # row: a draft near the start may read them.
    ids = np.zeros(rows, np.int64)
    ids[:plen] = prompt
    tokens = np.zeros(length, np.int32)
    p0 = blocks = gen_blocks = 0
    while p0 < plen - 1 + length:
        in_tok = draft_inputs(ids, p0, plen, T)
        ids[p0:p0 + T] = in_tok
        logits = _block_logits(packed, w32, config, kc, vc, in_tok, p0)  # (T, Vpad)

        if greedy:
            samples = first_argmax(logits)
        else:
            scaled = logits * (1.0 / temps)[:, None]
            if use_filters:
                scaled = filtered_scaled_logits(scaled, topks, topps)
            noise = torch.cat([gumbel_noise(seed, 1, p0 + t, vpad, device) for t in range(T)])
            samples = first_argmax(scaled + noise)
        samples = samples.cpu().numpy()

        # Row t matches when its successor in the block is a prompt token or
        # equals its sample; n_emit = 1 + leading matches.
        n_emit = 1
        while n_emit < T and (p0 + n_emit < plen or samples[n_emit - 1] == in_tok[n_emit]):
            n_emit += 1
        for t in range(n_emit):
            slot = p0 + t - (plen - 1)
            if 0 <= slot < length:
                tokens[slot] = samples[t]
        if p0 + n_emit >= plen:
            ids[p0 + n_emit] = samples[n_emit - 1]
        gen_blocks += int(p0 >= plen - 1)
        blocks += 1
        p0 += n_emit
    stats = np.array([blocks, gen_blocks, p0, 0, 0, 0, 0, 0], np.int32)
    return (torch.as_tensor(tokens, device=device),
            torch.as_tensor(stats, device=device))


def spec_decode(packed, prompt, seed: int, temp: float, topk: float, topp: float, *,
                config, length: int, cache_len: int, block: int, phase_ns=None):
    """Runs the speculative generation of ``length`` ids after ``prompt``
    (an int32 ``(plen,)`` tensor on the weights' device). ``temp <= 0`` is
    greedy; ``topk``/``topp`` carry the filter sentinels of ``row_params``.
    Returns ``(tokens (length,), stats (8,))`` int32:
    ``stats = [blocks, generation blocks, final position, 0...]``.

    On CPU tensors this is the plain version. On CUDA tensors it launches
    the kernel on one cluster of G blocks (``cluster_size`` at batch 1,
    kept in ``spec_decode.cluster``), counted in ``spec_decode.launches``,
    or raises. ``phase_ns`` (optional ``(len(PHASES),)`` int64 on the card)
    accumulates the nanoseconds the cluster's first block spends in each
    phase kind of its verify blocks.
    """
    device = packed["wte"].device
    if device.type == "cpu":
        return speculative_generate_reference(
            packed, prompt, seed, temp, topk, topp, config=config, length=length,
            cache_len=cache_len, block=block,
        )
    if device.type != "cuda":
        raise ValueError(f"spec_decode runs on CPU or CUDA tensors, not {device}")
    if not spec_kernel_fits(config, cache_len, block):
        raise ValueError(
            f"the kernel takes head_dim % 8 == 0, block in [2, 16] and at most "
            f"{MAX_SHARED_BYTES} bytes of shared memory; cache_len {cache_len} at block "
            f"{block} needs {spec_smem_bytes(config, cache_len, block)}, head_dim is "
            f"{config.head_dim}"
        )
    from composer_tpu_torch.ops._build import load_library

    L, E = config.num_layers, config.embed_dim
    wdtype = packed["wte"].dtype
    if wdtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes float32 or bfloat16 weights, not {wdtype}")
    plen = prompt.shape[0] if prompt.dim() == 1 else -1
    if plen < 1 or plen + length > cache_len or length < 1:
        raise ValueError(f"need a (plen,) prompt, plen >= 1, length >= 1 and "
                         f"plen + length <= cache_len {cache_len}")
    vpad = packed["wte"].shape[0]
    if packed["wte_t"].shape != (E, vpad) or packed["qkv_w"].shape != (L, E, 3 * E):
        raise ValueError("packed weights do not match the config")
    if config.use_relative_attention and packed["rel_rows"].shape[1] != config.window_size:
        raise ValueError("rel_rows must hold window_size rows with relative attention on")
    if phase_ns is not None and (phase_ns.device != device or phase_ns.dtype != torch.int64
                                 or phase_ns.shape != (len(PHASES),)):
        raise ValueError(f"phase_ns must be a ({len(PHASES)},) int64 tensor on {device}")

    rows = cache_len + block

    def extra(g):
        passes = spec_cluster_passes(config, cache_len, block, g)
        return None if passes is None else (block, *passes)

    cluster = launch_cluster_size("spec_decode", config, 1, rows, wdtype, device, extra)
    passes = spec_cluster_passes(config, cache_len, block, cluster)
    if passes is None:
        raise ValueError(
            f"cache_len {cache_len} at block {block} does not fit a block of a {cluster}-block "
            f"cluster ({spec_cluster_smem_bytes(config, cache_len, block, cluster)} bytes of "
            f"shared memory at the smallest passes; {MAX_SHARED_BYTES} available), or "
            f"{cluster} does not divide the heads and vocabulary")
    # Scratch: every K/V row and id the kernel reads it has written first.
    kcache = torch.empty((L, rows, E), dtype=wdtype, device=device)
    vcache = torch.empty((L, rows, E), dtype=wdtype, device=device)
    out = torch.empty((length + 8,), dtype=torch.int32, device=device)
    inputs = {name: packed[name] for name in (
        "wte", "wte_t", "wpe", "ln1", "qkv_w", "qkv_b", "proj_w", "proj_b",
        "fc_w", "fc_b", "fp_w", "fp_b", "rel_rows")}
    inputs.update(logits_b=_logits_bias(packed, config), kcache=kcache, vcache=vcache,
                  prompts=prompt)
    _check_cuda_inputs(inputs, device, wdtype)

    lib = load_library("spec_decode")
    ptr = ctypes.c_void_p
    err = lib.spec_decode(
        ctypes.c_int(1 if wdtype == torch.bfloat16 else 0),
        ctypes.c_int(device.index if device.index is not None else torch.cuda.current_device()),
        *(ptr(inputs[name].data_ptr()) for name in (
            "wte", "wte_t", "wpe", "ln1", "qkv_w", "qkv_b", "proj_w", "proj_b",
            "fc_w", "fc_b", "fp_w", "fp_b", "logits_b", "rel_rows", "kcache", "vcache",
            "prompts")),
        ptr(out.data_ptr()),
        *(ctypes.c_int(int(v)) for v in (
            plen, L, config.num_heads, config.head_dim, E, rows, config.window_size, vpad,
            length, block, config.use_relative_attention)),
        ctypes.c_uint(int(seed) & 0xFFFFFFFF),
        ctypes.c_float(float(temp) if temp > 0 else 0.0),
        ctypes.c_float(float(topk)),
        ctypes.c_float(float(topp)),
        ctypes.c_float(float(config.head_dim) ** -0.5 if config.scale_attention else 1.0),
        ctypes.c_float(config.layer_norm_epsilon),
        *(ctypes.c_int(v) for v in (cluster, *passes)),
        ptr(phase_ns.data_ptr() if phase_ns is not None else 0),
        ptr(torch.cuda.current_stream(device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"spec_decode kernel launch failed (cluster {cluster}, passes "
                           f"{passes}): CUDA error {err}")
    spec_decode.cluster = cluster
    spec_decode.launches += 1
    return out[:length], out[length:]


spec_decode.launches = 0
spec_decode.cluster = None  # G of the last launch


def speculative_generate(packed, prompt, seed, temperature, *, config, length: int,
                         cache_len: int, block: int = None, top_k=0, top_p=0.0,
                         greedy=None, use_k=None, use_p=None):
    """Single-sequence speculative generation in one kernel launch.

    prompt: int array ``(P,)``. Returns ``(tokens, stats)`` on the packed
    weights' device: the ``(length,)`` continuation and the ``(8,)`` int32
    vector ``[total_blocks, generation_blocks, final_position, 0...]``; the
    mean accepted tokens per generation block is
    ``length / generation_blocks``. The device of ``packed`` decides: the
    CPU runs the plain version, CUDA the kernel.

    Greedy ids (``temperature <= 0``) equal the sequential kernel's
    (``megakernel_generate``), and so do sampled ids: both draw the Philox
    noise of (seed, row 0, position), and the kernel sums each row in the
    sequential kernel's order.
    """
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    plen = prompt.shape[0]
    if plen + length > cache_len:
        raise ValueError(f"prompt ({plen}) + length ({length}) exceeds cache ({cache_len})")
    greedy, use_k, use_p = sampling_flags(temperature, top_k, top_p, greedy, use_k, use_p)
    if block is None:
        block = default_block(greedy)
    if block < SPEC_BLOCK_MIN or block > SPEC_BLOCK_MAX:
        raise ValueError(f"speculative block must be in [2, 16], got {block}")
    device = packed["wte"].device
    temps, topk, topp = row_params(1, packed["wte"].shape[0], temperature, top_k, top_p,
                                   greedy, use_k, use_p, "cpu")
    return spec_decode(
        packed, torch.as_tensor(prompt).to(device), seed, float(temps[0]), float(topk[0]),
        float(topp[0]), config=config, length=length, cache_len=cache_len, block=block,
    )
