"""Fused decoding for models whose weights outgrow the card's fast memory.

Port of ``composer_tpu/ops/decode_kernel_wide.py``. The Hopper kernel
``decode_wide`` (``csrc/decode_wide.cu``, CUDA C++ for ``sm_90a``) replaces
the TPU kernel ``_wide_kernel``.

``decode_generate`` runs one block per sequence, and each block reads every
layer's weights at every step. The default model's 12.6 MB of bf16 weights
stay in the 50 MB L2, so that costs little. The embed-1024 flagship packs
about 200 MB, which no cache holds: B blocks each streaming 200 MB from HBM
per step, at one SM's read rate, take seconds for a generation. The wide
kernel reads each weight byte once per step for all B rows, spread over
every SM: one cooperative persistent launch for the whole generation, with
grid-wide barriers between the phases of a layer (ln_1 + qkv, attention,
proj, ln_2 + fc, fp, then the logits and the sampling). In each matmul
phase every block owns a fixed slice of output columns (``wide_tiles``),
streams it into shared memory ahead of the phase's barrier and applies each
weight to all B rows on tensor cores; attention runs (row, head, key split)
items on warp groups (``wide_attention_items``). The step body is
``csrc/decode_wide_common.cuh``'s, shared with ``decode_segment_wide``.

What the port keeps of the TPU kernel is its semantics, not its layout:

* the K/V cache is ``(L, 2, B, cache_len, E)`` (k at ``[:, 0]``, v at
  ``[:, 1]``) in the activation dtype, carried by the caller across calls
  and written in place; a step writes its row straight to the cache;
* int8 K/V (``init_kv_state(quantize_kv=True)``) holds an int8 cache, its
  per-(row, sequence, k|v) scales (``quantize_kv_segments``) and a float
  ``TAIL``-row window per layer. Row r is read as float from the window
  until the 128-row window that holds it is complete (position
  ``(r // TAIL + 1) * TAIL``), and from the int8 cache after, as on the
  TPU, where the window is quantized when it is flushed. The scales are per
  row, so the kernel quantizes each row when it is written; it is first
  read quantized only after its window is complete. Tokens before position
  ``TAIL`` are therefore bit-identical to float K/V;
* int8 weights carry per-output-channel scales, applied to the matmul's
  output; x is rounded to bf16 before the product, as ``_wide_matmul``
  casts it to the weights' (bf16) compute type;
* every call starts at position 0 and reads only rows it wrote itself, so a
  reused (dirtied) state gives the same ids as a fresh one.

Sampling draws the Philox4x32-10 Gumbel noise keyed by (seed, row, step,
lane), as ``decode_generate`` does (``csrc/decode_common.cuh``), so wide and
fused ids are identical in float32, greedy and sampled, and so are those of
their plain versions.
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

# Rows of the float window of int8 K/V: a row is read quantized once the
# window that holds it is complete.
TAIL = 128
# The kernel's limits: rows per launch (the tensor-core products' 8 rows)
# and attention splits per (row, head) (its partials buffer).
MAX_BATCH = 8
MAX_SPLITS = 16
# The slots of the kernel's optional clock, block 0's (ns unless said): its
# own work in each phase kind not counted in the slots after; the matmul
# phases' wait for their input rows with the LayerNorm; their wait for
# weight tiles; the attention's key pass and its merge (block 0's first
# warp group); the wait at grid barriers; and the number of grid barriers
# (a count, not ns).
PHASES = ("ln_1 + qkv", "attention", "proj", "ln_2 + fc", "fp", "logits", "sampling",
          "input rows + LayerNorm", "weight tile wait", "attention keys", "attention merge",
          "grid barrier wait", "grid barriers (count)")
# The streamed weights' tiles (csrc/decode_wide_common.cuh): two stages of
# STAGE_BYTES of shared memory, tiles of at most MAX_TILE_UNITS units of 8
# output columns. An attention item runs on a block, whose GROUPS_PER_BLOCK
# warp groups of GROUP_THREADS take quarters of its keys; at most one key
# split for every MIN_SPLIT_KEYS keys.
STAGE_BYTES = 65536
MAX_TILE_UNITS = KERNEL_THREADS // 32
GROUP_THREADS = 128
GROUPS_PER_BLOCK = KERNEL_THREADS // GROUP_THREADS
MIN_SPLIT_KEYS = 64
# Shared memory ahead of the kernel's union: the stages' mbarriers, the row
# list and the tile geometry (512 bytes), 64 floats of reductions and 1024 of
# matmul sums.
HEADER_BYTES = 512 + 4 * (64 + 1024)
# Weight kinds of the C entry point.
_WEIGHT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _quantize_rows(rows):
    """Per-row symmetric int8: ``(q, scale)`` with ``scale = max|row| / 127``
    (at least ``1e-12 / 127``); the arithmetic of the JAX package's
    ``quantize_kv_segments``, which the kernel repeats."""
    x = rows.float()
    m = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    q = torch.round(x * (127.0 / m)).clamp(-127.0, 127.0).to(torch.int8)
    return q, (m * (1.0 / 127.0))[..., 0]


def quantize_kv_segments(block, num_segments: int, seg_width: int):
    """Per-(row, segment) symmetric int8 quantization of a ``(rows,
    num_segments * seg_width)`` block: ``(q int8 of the same shape, scales
    (rows, num_segments) float32)`` with ``scales[r, j] = max|segment| / 127``
    (guarded below by ``1e-12``), so ``q * scale`` sits within half a
    quantization step of the original."""
    rows = block.shape[0]
    q, scales = _quantize_rows(block.reshape(rows, num_segments, seg_width))
    return q.reshape(rows, num_segments * seg_width), scales


def pack_weights_wide(state_dict, config, dtype=torch.bfloat16, device=None):
    """The port's ``state_dict`` -> the tensors the wide kernel streams.

    Built on ``ops/decode_kernel.py::pack_weights`` (ln_2 and ln_f folded,
    biases float32). The kernel reads a weight row per output column, so the
    matmul blocks are stored output-major: ``big_w`` ``(L, 8E, E)`` holds the
    qkv, attention-proj and mlp-fc columns (rows ``[0, 3E)``, ``[3E, 4E)``,
    ``[4E, 8E)``), ``fp_w`` ``(L, E, 4E)`` the mlp-proj columns, and
    ``logits_w`` ``(Vpad, E)`` the ln_f-folded tied head. The JAX package's
    ``big_w`` / ``fp_w`` / ``wte_t`` are their transposes.

    ``dtype=torch.int8`` quantizes ``big_w`` and ``fp_w`` per output channel
    (``wscale`` ``(L, 8E)``, ``fpscale`` ``(L, E)``: ``max|w_col| / 127``,
    at least ``1e-12``); the embeddings, the relative table and the head
    then stay bfloat16. int8 is not bit-identical to bf16.
    """
    quantized = dtype == torch.int8
    act = torch.bfloat16 if quantized else dtype
    if device is None:
        device = state_dict["wte"].device
    base = dk.pack_weights(state_dict, config, dtype=torch.float32, device=device)
    big = torch.cat([base["qkv_w"], base["proj_w"], base["fc_w"]], dim=2).transpose(1, 2)
    fp = base["fp_w"].transpose(1, 2)
    packed = {}
    if quantized:
        for name, w, scale_name in (("big_w", big, "wscale"), ("fp_w", fp, "fpscale")):
            scale = (w.abs().amax(dim=2) / 127.0).clamp_min(1e-12)  # (L, N)
            packed[name] = torch.round(w / scale[..., None]).clamp(-127, 127).to(
                torch.int8).contiguous()
            packed[scale_name] = scale.contiguous()
    else:
        packed["big_w"] = big.to(dtype).contiguous()
        packed["fp_w"] = fp.to(dtype).contiguous()
    packed.update(
        wte=base["wte"].to(act).contiguous(),
        logits_w=base["wte_t"].t().to(act).contiguous(),
        wpe=base["wpe"].to(act).contiguous(),
        rel_rows=base["rel_rows"].to(act).contiguous(),
        **{name: base[name] for name in ("ln1", "qkv_b", "proj_b", "fc_b", "fp_b", "logits_b")},
    )
    return packed


def init_kv_state(config, batch: int, cache_len: int, dtype=torch.bfloat16,
                  quantize_kv: bool = False, device=None):
    """Zeroed K/V state ``(L, 2, batch, cache_len, E)`` of ``dtype``, carried
    across calls. ``quantize_kv=True`` returns the int8 triple instead: the
    int8 cache of that shape, its scales ``(L, 2, batch, cache_len)`` float32
    and the float window ``(L, 2, batch, TAIL, E)`` of ``dtype``. ``dtype``
    is the packed weights' activation dtype (bfloat16 for int8 weights)."""
    shape = (config.num_layers, 2, batch, cache_len, config.embed_dim)
    if quantize_kv:
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:4], dtype=torch.float32, device=device),
                torch.zeros(shape[:3] + (TAIL, config.embed_dim), dtype=dtype, device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


def _weight_bytes(dtype) -> tuple:
    """(bytes of a streamed weight, bytes of an activation) for a packing
    dtype: bf16 and int8 weights run bf16 activations."""
    if dtype == torch.float32:
        return 4, 4
    return (1 if dtype == torch.int8 else 2), 2


def wide_smem_bytes(config, batch: int, cache_len: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one block for weights of ``dtype``; mirrors
    ``smem_bytes`` in csrc/decode_wide_common.cuh: the header, a union of the
    phases' operands (LayerNorm's ``B x E`` float rows and their ``B x E``
    operand in the activation dtype, the fp operand ``B x 4E``, the
    attention merge: the block's thread groups' sums, a partial sum a
    thread and a (row, head)'s ``MAX_SPLITS`` partials, and the sampling
    teams' sorts: per row its padded vocabulary, rounded up to a power of
    two, in floats and in doubles, and a double a warp), rounded
    up to 128 bytes, and, for bf16 and int8 weights, two weight stages.
    ``cache_len`` no longer matters: attention keeps no per-key buffer."""
    del cache_len
    E, D = config.embed_dim, config.head_dim
    wbytes, abytes = _weight_bytes(dtype)
    lanes = D // (16 // abytes)
    attention = (GROUPS_PER_BLOCK * (GROUP_THREADS // lanes) * (D + 3) + KERNEL_THREADS
                 + MAX_SPLITS * (D + 2) + 4)
    sort = 1 << (dk.vocab_pad(config) - 1).bit_length()  # sort_length
    union = max(batch * E * (4 + abytes), 4 * batch * E * abytes, 4 * attention,
                batch * (12 * sort + 8 * (KERNEL_THREADS // 32)))
    union = -(-union // 128) * 128
    return HEADER_BYTES + union + (2 * STAGE_BYTES if wbytes != 4 else 0)


def wide_kernel_fits(config, batch: int, cache_len: int, dtype=torch.bfloat16) -> bool:
    """The kernel's limits for weights of ``dtype``: at most ``MAX_BATCH``
    rows, shared memory within 227 KB, embed a multiple of 16 (16-byte
    loads of the rows and the tiles), head_dim a multiple of 8 (16-byte bf16
    loads of a head), at most 128 (a key's lanes within one warp) and
    dividing the block's 512 threads."""
    D = config.head_dim
    return (1 <= batch <= MAX_BATCH and wide_smem_bytes(config, batch, cache_len, dtype)
            <= MAX_SHARED_BYTES and config.embed_dim % 16 == 0 and D % 8 == 0
            and D <= 128 and KERNEL_THREADS % D == 0)


def tile_geom(N: int, K: int, wbytes: int, grid: int) -> dict:
    """One matmul phase's tiles; mirrors ``tile_geom`` in
    csrc/decode_wide_common.cuh. ``units`` of 8 output columns; a tile holds
    ``upt`` units of the whole K (``kts`` = 1) or, where one unit of K
    outgrows a stage, one unit of ``kc`` of K (``kts`` chunks); column group
    g (``upt`` units) belongs to block ``g % grid``."""
    units = N // 8
    unit_bytes = 8 * K * wbytes
    if unit_bytes <= STAGE_BYTES:
        upt = min(-(-units // grid), STAGE_BYTES // unit_bytes, MAX_TILE_UNITS)
        kc, kts = K, 1
    else:
        upt, kc = 1, STAGE_BYTES // (8 * wbytes) // 32 * 32
        kts = -(-K // kc)
    return dict(units=units, upt=upt, kc=kc, kts=kts, groups=-(-units // upt), K=K)


def wide_tiles(config, grid: int, dtype=torch.bfloat16) -> dict:
    """The static slices of the streamed matmul phases: for each phase
    (``qkv``, ``proj``, ``fc``, ``fp``, ``logits``), the tiles in the order
    the kernel streams them, as ``(block, first column, columns, first k,
    k length, bytes)``. Every output column and k of a phase lies in exactly
    one tile, whatever ``grid`` is (the CPU tests check it)."""
    E, V = config.embed_dim, dk.vocab_pad(config)
    wbytes, abytes = _weight_bytes(dtype)
    shapes = {"qkv": (3 * E, E, wbytes), "proj": (E, E, wbytes), "fc": (4 * E, E, wbytes),
              "fp": (E, 4 * E, wbytes), "logits": (V, E, abytes)}
    tiles = {}
    for name, (N, K, wb) in shapes.items():
        g = tile_geom(N, K, wb, grid)
        tiles[name] = []
        for block in range(grid):
            for group in range(block, g["groups"], grid):
                units = min(g["upt"], g["units"] - group * g["upt"])
                for chunk in range(g["kts"]):
                    k0 = chunk * g["kc"]
                    klen = min(g["kc"], K - k0)
                    tiles[name].append((block, group * g["upt"] * 8, units * 8, k0, klen,
                                        units * 8 * klen * wb))
    return tiles


def wide_attention_items(key_positions, heads: int, grid: int) -> list:
    """A step's attention items; mirrors ``plan_splits`` and the item loop of
    ``attention_phase`` in csrc/decode_wide_common.cuh. Row b (keys
    ``[0, key_positions[b]]``) gets ``S`` key splits, at most one for every
    ``MIN_SPLIT_KEYS`` keys (so none is empty) and at most ``MAX_SPLITS``,
    enough to cover the grid's blocks; item i runs on block ``i % grid``,
    whose warp groups take quarters of its keys. Returns ``(row, head,
    split, first key, end key, block, [(first key, end key) of each warp
    group])`` for every item."""
    B = len(key_positions)
    cap = min(max(grid // (B * heads), 1), MAX_SPLITS)
    items = []
    for b, key_pos in enumerate(key_positions):
        n = key_pos + 1
        S = min((key_pos + MIN_SPLIT_KEYS) // MIN_SPLIT_KEYS, cap)
        per = -(-n // S)
        for hh in range(heads):
            for s in range(S):
                j0, j1 = s * per, min(n, s * per + per)
                quarter = -(-(j1 - j0) // GROUPS_PER_BLOCK)
                starts = [min(j1, j0 + g * quarter) for g in range(GROUPS_PER_BLOCK)]
                quarters = [(k0, min(j1, k0 + quarter)) for k0 in starts]
                items.append((b, hh, s, j0, j1, len(items) % grid, quarters))
    return items


def _split_state(kv_state):
    """``(kv, kq, ks, tail)``: the float cache, or the int8 triple."""
    if isinstance(kv_state, tuple):
        return (None, *kv_state)
    return kv_state, None, None, None


def decode_wide_reference(packed, kv_state, prompts, plens, seed, temps, topk, topp, *,
                          config, num_steps: int, out_len: int, cache_len: int,
                          logits_out=None, step_logits=None):
    """The plain PyTorch version of the wide kernel (same contract as
    ``decode_wide``), one step at a time with float32 accumulation.

    Matmul operands are rounded to the activation dtype (bf16 for int8
    weights) and the int8 scale multiplies the product. q is rounded to the
    K/V dtype; scores, softmax and the AV product stay float32. An int8 row
    contributes ``(q . k_q) * k_scale`` and ``p * v_scale * v_q``. Updates
    ``kv_state`` in place.
    """
    device = packed["wte"].device
    act = packed["wte"].dtype
    B = prompts.shape[0]
    L, H, D, E = config.num_layers, config.num_heads, config.head_dim, config.embed_dim
    W, eps = config.window_size, config.layer_norm_epsilon
    vpad = packed["wte"].shape[0]
    use_filters = bool(((topk < vpad) | (topp < 1)).any())
    kv, kq, ks, tail = _split_state(kv_state)
    w32 = {name: packed[name].float() for name in (
        "big_w", "fp_w", "wte", "logits_w", "wpe", "rel_rows")}
    wscale, fpscale = packed.get("wscale"), packed.get("fpscale")
    logits_b = _logits_bias(packed, config)
    scale = float(D) ** -0.5 if config.scale_attention else 1.0

    def mm(x, w, s=None):
        out = x.to(act).float() @ w.t()
        return out if s is None else out * s

    prompts = prompts.long()
    plens = plens.long()
    rows = torch.arange(B, device=device)
    tokens = torch.zeros((B, out_len), dtype=torch.int32, device=device)
    token = prompts[:, 0]

    for pos in range(num_steps):
        n = pos + 1
        h = w32["wte"][token] + w32["wpe"][min(pos, W - 1)]
        slots = torch.arange(n, device=device)
        r = W - 1 - (pos - slots)
        valid = (r >= 0)[:, None]
        for layer in range(L):
            big = w32["big_w"][layer]
            s_big = wscale[layer] if wscale is not None else None
            ln1 = packed["ln1"][layer]
            x1 = _standardize(h, eps) * ln1[0] + ln1[1]
            qkv = mm(x1, big[:3 * E], None if s_big is None else s_big[:3 * E]) \
                + packed["qkv_b"][layer]
            q, k, v = qkv[:, :E], qkv[:, E:2 * E], qkv[:, 2 * E:]
            qh = q.to(act).float().reshape(B, H, D)
            if tail is None:
                kv[layer, 0, :, pos] = k.to(kv.dtype)
                kv[layer, 1, :, pos] = v.to(kv.dtype)
                keys = kv[layer, 0, :, :n].float().reshape(B, n, H, D)
                scores = torch.einsum("bhd,bjhd->bhj", qh, keys)
            else:
                tail[layer, 0, :, pos % TAIL] = k.to(act)
                tail[layer, 1, :, pos % TAIL] = v.to(act)
                for which in (0, 1):
                    kq[layer, which, :, pos], ks[layer, which, :, pos] = _quantize_rows(
                        tail[layer, which, :, pos % TAIL])
                flushed = pos // TAIL * TAIL
                old = kq[layer, 0, :, :flushed].float().reshape(B, flushed, H, D)
                new = tail[layer, 0, :, :n - flushed].float().reshape(B, n - flushed, H, D)
                scores = torch.cat([
                    torch.einsum("bhd,bjhd->bhj", qh, old) * ks[layer, 0, :, None, :flushed],
                    torch.einsum("bhd,bjhd->bhj", qh, new)], dim=-1)
            if config.use_relative_attention:
                band = w32["rel_rows"][layer][r.clamp(0, W - 1)] * valid
                scores = scores + torch.einsum("bhd,jhd->bhj", qh, band.reshape(n, H, D))
            scores = scores * scale
            p = torch.exp(scores - scores.max(dim=-1, keepdim=True).values)
            if tail is None:
                values = kv[layer, 1, :, :n].float().reshape(B, n, H, D)
                mixed = torch.einsum("bhj,bjhd->bhd", p, values)
            else:
                old = kq[layer, 1, :, :flushed].float().reshape(B, flushed, H, D)
                new = tail[layer, 1, :, :n - flushed].float().reshape(B, n - flushed, H, D)
                mixed = (torch.einsum("bhj,bjhd->bhd",
                                      p[..., :flushed] * ks[layer, 1, :, None, :flushed], old)
                         + torch.einsum("bhj,bjhd->bhd", p[..., flushed:], new))
            attn = (mixed / p.sum(-1, keepdim=True)).reshape(B, E)
            x2 = x1 + (mm(attn, big[3 * E:4 * E], None if s_big is None else s_big[3 * E:4 * E])
                       + packed["proj_b"][layer])
            hidden = _gelu_tanh(mm(_standardize(x2, eps), big[4 * E:],
                                   None if s_big is None else s_big[4 * E:])
                                + packed["fc_b"][layer])
            h = x2 + mm(hidden, w32["fp_w"][layer],
                        None if fpscale is None else fpscale[layer]) + packed["fp_b"][layer]
        logits = mm(_standardize(h, eps), w32["logits_w"]) + logits_b  # (B, Vpad)
        if logits_out is not None and pos == num_steps - 1:
            logits_out.copy_(logits)
        if step_logits is not None:
            step_logits[:, pos] = logits

        next_token = dk.sample_rows(logits, temps, topk, topp, seed, pos, use_filters)

        col = pos - plens + 1
        hit = (col >= 0) & (col < out_len)
        tokens[rows[hit], col[hit]] = next_token[hit].to(torch.int32)
        forced = prompts[:, min(pos + 1, prompts.shape[1] - 1)]
        token = torch.where(pos + 1 < plens, forced, next_token)
    return tokens


def _scratch_floats(batch: int, config) -> int:
    """The kernel's float32 scratch; mirrors ``scratch_floats`` in
    csrc/decode_wide_common.cuh: x1, q, x2 and h (B x E each), the attention
    output (B x E, held in the activation dtype), the MLP hidden (B x 4E,
    likewise), the logits (B x Vpad), the attention partials
    (B x H x MAX_SPLITS x (D + 2)), then ints: the B x H split counters and
    the grid barrier's counter. Allocated zeroed."""
    E, H, D = config.embed_dim, config.num_heads, config.head_dim
    return (9 * batch * E + batch * dk.vocab_pad(config)
            + batch * H * MAX_SPLITS * (D + 2) + batch * H + 1)


def _check_packed(packed, config):
    """Raises unless ``packed`` is a ``pack_weights_wide`` packing for ``config``."""
    L, E = config.num_layers, config.embed_dim
    act = packed["wte"].dtype
    wdtype = packed["big_w"].dtype
    if wdtype not in _WEIGHT_KINDS or act != (
            torch.float32 if wdtype == torch.float32 else torch.bfloat16):
        raise ValueError(f"weights {wdtype} with tables {act}: pack with pack_weights_wide")
    if (wdtype == torch.int8) != ("wscale" in packed):
        raise ValueError("int8 weights need their scales (and only they have them)")
    vpad = packed["wte"].shape[0]
    if packed["big_w"].shape != (L, 8 * E, E) or packed["logits_w"].shape != (vpad, E):
        raise ValueError("packed weights do not match the config")
    if config.use_relative_attention and packed["rel_rows"].shape[1] != config.window_size:
        raise ValueError("rel_rows must hold window_size rows with relative attention on")


def _check_cuda_tensors(inputs, device, checked, int_names):
    """Every tensor of ``inputs`` (None skipped) contiguous, 16-byte aligned
    and on ``device``; those outside ``checked`` int32 when named in
    ``int_names``, else float32."""
    for name, t in inputs.items():
        if t is None:
            continue
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            # The kernels read rows with 16-byte vector loads.
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {device}")
        expected = torch.int32 if name in int_names else torch.float32
        if name not in checked and t.dtype != expected:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {expected}")


def _check_inputs(packed, kv_state, prompts, plens, temps, topk, topp, config, cache_len,
                  num_steps, out_len, logits_out):
    _check_packed(packed, config)
    B = prompts.shape[0]
    L, E = config.num_layers, config.embed_dim
    act = packed["wte"].dtype
    vpad = packed["wte"].shape[0]
    kv, kq, ks, tail = _split_state(kv_state)
    shape = (L, 2, B, cache_len, E)
    if kv is not None:
        if tuple(kv.shape) != shape or kv.dtype != act:
            raise ValueError(f"kv_state {tuple(kv.shape)} {kv.dtype} does not match "
                             f"{shape} {act} (init_kv_state with the same batch/cache_len)")
    elif (tuple(kq.shape) != shape or kq.dtype != torch.int8 or tuple(ks.shape) != shape[:4]
          or tuple(tail.shape) != shape[:3] + (TAIL, E) or tail.dtype != act):
        raise ValueError("an int8 kv_state is (int8 cache, scales, float window) from "
                         "init_kv_state(quantize_kv=True) with the same batch/cache_len")
    if any(t.shape != (B,) for t in (plens, temps, topk, topp)) or (
            logits_out is not None and logits_out.shape != (B, vpad)):
        raise ValueError("per-row inputs must be (B,) and logits_out (B, Vpad)")
    if int(plens.min()) < 1 or int(plens.max()) > prompts.shape[1]:
        raise ValueError("need 1 <= plens <= prompt width")
    if num_steps > cache_len or out_len < 1:
        raise ValueError(f"num_steps {num_steps} exceeds cache_len {cache_len}, or no output")


def decode_wide(packed, kv_state, prompts, plens, seed, temps, topk, topp, *, config,
                num_steps: int, out_len: int, cache_len: int, logits_out=None, grid: int = 0,
                phase_ns=None):
    """Runs steps ``[0, num_steps)`` for B rows at once, writing ``kv_state``.

    prompts ``(B, P)`` and plens ``(B,)`` int32; temps, topk, topp ``(B,)``
    float32 with the filter sentinels (``row_params``); ``kv_state`` from
    ``init_kv_state``. Returns ``(B, out_len)`` int32 ids: row s's sample at
    step i lands in column ``i - plens[s] + 1``. ``logits_out`` (optional
    ``(B, Vpad)`` float32) receives the last step's logits. ``grid`` is the
    number of blocks (0: one per SM); a grid that cannot be resident at once
    is refused, since its barriers would never open. ``phase_ns`` (optional
    ``(len(PHASES),)`` int64 on the card) accumulates block 0's clock
    (``PHASES``): its own work in each phase kind and its wait at the grid
    barriers in nanoseconds, and the number of grid barriers.

    On CPU tensors this is the plain version. On CUDA tensors it launches the
    kernel (counted in ``decode_wide.launches``) or raises.
    """
    device = packed["wte"].device
    _check_inputs(packed, kv_state, prompts, plens, temps, topk, topp, config, cache_len,
                  num_steps, out_len, logits_out)
    if device.type == "cpu":
        return decode_wide_reference(
            packed, kv_state, prompts, plens, seed, temps, topk, topp, config=config,
            num_steps=num_steps, out_len=out_len, cache_len=cache_len, logits_out=logits_out)
    if device.type != "cuda":
        raise ValueError(f"decode_wide runs on CPU or CUDA tensors, not {device}")
    if phase_ns is not None and (phase_ns.device != device or phase_ns.dtype != torch.int64
                                 or phase_ns.shape != (len(PHASES),)):
        raise ValueError(f"phase_ns must be a ({len(PHASES)},) int64 tensor on {device}")
    B = prompts.shape[0]
    wdtype = packed["big_w"].dtype
    if not wide_kernel_fits(config, B, cache_len, wdtype):
        raise ValueError(
            f"the kernel takes 1..{MAX_BATCH} rows, embed % 16 == 0, head_dim % 8 == 0 "
            f"up to 128 dividing {KERNEL_THREADS}, and at most {MAX_SHARED_BYTES} bytes of shared "
            f"memory; batch {B} needs {wide_smem_bytes(config, B, cache_len, wdtype)}")
    import ctypes

    from composer_tpu_torch.ops._build import load_library

    kv, kq, ks, tail = _split_state(kv_state)
    tokens = torch.zeros((B, out_len), dtype=torch.int32, device=device)
    # Zeroed: the split counters and the grid barrier's counter start at 0.
    scratch = torch.zeros(_scratch_floats(B, config), dtype=torch.float32, device=device)
    inputs = {name: packed.get(name) for name in (
        "big_w", "fp_w", "wscale", "fpscale", "wte", "logits_w", "wpe", "ln1", "qkv_b",
        "proj_b", "fc_b", "fp_b")}
    inputs.update(logits_b=_logits_bias(packed, config), rel_rows=packed["rel_rows"], kv=kv,
                  kq=kq, ks=ks, tail=tail, prompts=prompts, plens=plens, temps=temps,
                  topk=topk, topp=topp, tokens=tokens, logits_out=logits_out, scratch=scratch)
    # The weights' and caches' dtypes were checked by _check_inputs.
    _check_cuda_tensors(inputs, device, ("big_w", "fp_w", "wte", "logits_w", "wpe", "rel_rows",
                                         "kv", "kq", "tail"), ("prompts", "plens", "tokens"))

    lib = load_library("decode_wide")
    ptr = ctypes.c_void_p
    err = lib.decode_wide(
        ctypes.c_int(_WEIGHT_KINDS[packed["big_w"].dtype]), ctypes.c_int(tail is not None),
        ctypes.c_int(device.index if device.index is not None else torch.cuda.current_device()),
        ctypes.c_int(grid),
        *(ptr(inputs[name].data_ptr() if inputs[name] is not None else 0) for name in (
            "big_w", "fp_w", "wscale", "fpscale", "wte", "logits_w", "wpe", "ln1", "qkv_b",
            "proj_b", "fc_b", "fp_b", "logits_b", "rel_rows", "kv", "kq", "ks", "tail",
            "prompts", "plens", "temps", "topk", "topp", "tokens", "logits_out", "scratch")),
        ptr(phase_ns.data_ptr() if phase_ns is not None else 0),
        *(ctypes.c_int(int(v)) for v in (
            scratch.numel(), B, prompts.shape[1], config.num_layers, config.num_heads,
            config.head_dim, config.embed_dim, cache_len, config.window_size,
            packed["wte"].shape[0], num_steps, out_len, config.use_relative_attention)),
        ctypes.c_uint(int(seed) & 0xFFFFFFFF),
        ctypes.c_float(float(config.head_dim) ** -0.5 if config.scale_attention else 1.0),
        ctypes.c_float(config.layer_norm_epsilon),
        ptr(torch.cuda.current_stream(device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"decode_wide kernel launch failed: CUDA error {err}")
    decode_wide.launches += 1
    return tokens


decode_wide.launches = 0


def megakernel_generate_wide(packed, kv_state, prompts, seed, temperature, *, config,
                             length: int, cache_len: int, top_k=0, top_p=0.0, greedy=None,
                             use_k=None, use_p=None, prompt_lengths=None):
    """Generates ``length`` ids per prompt row in one wide-kernel launch;
    returns ``(tokens, kv_state)``: pass the state to the next call (the
    kernel writes it in place, so it is the same object). ``kv_state`` may
    be the int8 triple of ``init_kv_state(quantize_kv=True)``.

    Prompt and sampling semantics are those of
    ``ops/decode_kernel_batched.py::megakernel_generate_batched``: ragged
    ``prompt_lengths``, per-row temperature / top-k / top-p, greedy rows in
    sampled batches; with the same seed both kernels draw the same noise.
    """
    device = packed["wte"].device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(device).contiguous()
    batch, width = prompts.shape
    if width + length > cache_len:
        raise ValueError("prompt + length exceeds cache")
    ragged = prompt_lengths is not None
    if ragged:
        plens = np.asarray(prompt_lengths, np.int32).reshape(-1)
        if plens.shape[0] != batch:
            raise ValueError(f"prompt_lengths has {plens.shape[0]} rows for a batch of {batch}")
        if plens.min() < 1 or plens.max() > width:
            raise ValueError(
                f"prompt_lengths must lie in [1, {width}], got [{plens.min()}, {plens.max()}]")
    else:
        plens = np.full(batch, width, np.int32)
    greedy, use_k, use_p = dk.sampling_flags(temperature, top_k, top_p, greedy, use_k, use_p)
    temps, topk, topp = dk.row_params(batch, packed["wte"].shape[0], temperature, top_k,
                                      top_p, greedy, use_k, use_p, device)
    num_steps = width + length - 1
    tokens = decode_wide(
        packed, kv_state, prompts, torch.as_tensor(plens).to(device), seed, temps, topk, topp,
        config=config, num_steps=num_steps, out_len=num_steps if ragged else length,
        cache_len=cache_len)
    return tokens[:, :length], kv_state
