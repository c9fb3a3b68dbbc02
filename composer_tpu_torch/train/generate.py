"""Autoregressive generation: port of ``composer_tpu/train/generate.py``.

Four engines, as in the JAX package:

* the speculative kernel (``_spec_generate``): at batch 1, one launch of the
  Hopper kernel ``spec_decode`` drafts tokens by n-gram lookup and verifies
  a block of them per forward pass (``ops/decode_kernel_spec.py``);
* the fused kernel (``TransformerDecoder``): one launch of the Hopper kernel
  ``decode_generate`` consumes the prompt and samples every new token;
  prompts whose common prefix is at least ``COMPOSER_PREFILL_MIN`` tokens
  (default 64) first run one batched prefill forward and hand its cache to
  the kernel;
* the wide kernel (``WideTransformerDecoder``): for weights that outgrow the
  card's fast memory, one launch of the Hopper kernel ``decode_wide`` per
  sub-batch of up to 8 rows reads each weight once per step for all rows,
  spread over every SM (``ops/decode_kernel_wide.py``); no prefill;
* the unfused path (``engine="xla"``, the JAX package's name for it): a
  prefill forward, then one cached forward and one sampling call per token.

MusicRNN has one path whatever the engine (``_rnn_generate``): the prompt
through the LSTM in eval mode, then one forward of one token and one
sampling call per event, the carry threaded through.

Routing (``generate_ids``), with the JAX package's gates: ``auto`` on a
CUDA device sends a transformer with layer norm whose packed weights
(``_packed_weight_bytes``) exceed the card's L2 to the wide kernel, and
otherwise a batch-1 greedy request (every temperature <= 0) to the
speculative kernel and every other request to the fused kernel; everything
on the CPU takes the unfused path. ``spec`` opts a batch-1 request into the
speculative engine, sampled ones included (its plain version on the CPU);
at batch > 1 it takes the unfused path. ``megakernel`` and ``wide`` run
their kernel on CUDA and its plain PyTorch version on the CPU. ``xla`` runs
the unfused path.

Under a mesh (a tensor-parallel Transformer's ``config.flash_mesh``, or
``mesh=`` for a data-parallel one or MusicRNN), every engine but ``auto``
and ``xla`` raises, and generation runs the unfused path, as the JAX
package's mesh serving does: each rank decodes its data coordinate's rows
of the prompt (with its heads' KV cache under tensor parallelism), samples
from a generator seeded by ``(seed, data coordinate)``, so that the ranks
of a model group, whose logits are equal, draw the same ids, and the rows
are then gathered over the data group: every rank returns the whole batch.

Positions past ``window_size`` clamp to the last learned position embedding.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.music_rnn import init_state as rnn_init_state
from composer_tpu_torch.models.transformer import init_cache
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops import decode_kernel_wide as dkw
from composer_tpu_torch.ops.decode_kernel_batched import kernel_fits, megakernel_generate_batched
from composer_tpu_torch.ops.decode_kernel_spec import (
    default_block,
    spec_kernel_fits,
    speculative_generate,
)
from composer_tpu_torch.ops.sampling import sample_filtered_rows
from composer_tpu_torch.parallel import mesh as mesh_lib


def _apply(model, params, tokens, cache):
    """The model's forward with ``params`` (a state_dict) or, for None, its
    own parameters."""
    if params is None:
        return model(tokens, cache)
    return torch.func.functional_call(model, params, (tokens, cache))


def _device(model, params) -> torch.device:
    source = params.values() if params is not None else model.parameters()
    return next(iter(source)).device


def _prefill(model, params, prompt, generator, cache_len: int, temperature, top_k, top_p):
    cache = init_cache(model.config, prompt.shape[0], cache_len, device=prompt.device)
    logits, cache = _apply(model, params, prompt, cache)
    token = sample_filtered_rows(generator, logits[:, -1], temperature, top_k, top_p)
    return cache, token


def _grow_cache(cache, new_len: int):
    """Zero-pads the cache's sequence axis (the fill index is unchanged)."""
    def pad(buf):
        return torch.nn.functional.pad(buf, (0, 0, 0, new_len - buf.shape[2]))

    return {
        "index": cache["index"],
        "layers": [{"k": pad(layer["k"]), "v": pad(layer["v"])} for layer in cache["layers"]],
    }


def _decode_segment(model, params, cache, token, generator, steps: int, temperature,
                    top_k, top_p):
    """``steps`` cached one-token forwards; returns the inputs it consumed."""
    consumed = []
    for _ in range(steps):
        logits, cache = _apply(model, params, token[:, None], cache)
        consumed.append(token)
        token = sample_filtered_rows(generator, logits[:, 0], temperature, top_k, top_p)
    return cache, token, torch.stack(consumed, dim=1)


def _ragged_transformer_generate(model, params, prompt, plens, generator, length: int,
                                 cache_len: int, temperature, top_k, top_p):
    """Ragged-prompt decode on the unfused path: prefill through the shortest
    prompt, then one token at a time, each row forced to its own prompt
    token while the step is inside its prefix. Row s's ``length`` ids start
    at sample ``plens[s] - min(plens)``."""
    batch, width = prompt.shape
    plens = np.asarray(plens, np.int32).reshape(-1)
    min_plen = int(plens.min())
    if min_plen < 1 or plens.max() > width:
        raise ValueError(
            f"prompt_lengths must lie in [1, {width}], got [{plens.min()}, {plens.max()}]"
        )
    num_steps = width + length - 1
    cache, token = _prefill(model, params, prompt[:, :min_plen], generator, cache_len,
                            temperature, top_k, top_p)
    plens_t = torch.as_tensor(plens, device=prompt.device).long()
    samples = [token]
    for position in range(min_plen, num_steps):
        forced = prompt[:, min(position, width - 1)]
        token = torch.where(position < plens_t, forced, token)
        logits, cache = _apply(model, params, token[:, None], cache)
        token = sample_filtered_rows(generator, logits[:, 0], temperature, top_k, top_p)
        samples.append(token)
    stack = torch.stack(samples, dim=1)
    gather = (plens_t - min_plen)[:, None] + torch.arange(length, device=prompt.device)[None]
    return torch.gather(stack, 1, gather)


def _transformer_generate(model, params, prompt, generator, length: int, cache_len: int,
                          temperature, top_k, top_p):
    """KV-cached decode with staged cache growth (256, 512, ...): each step
    attends over the current stage, not the whole final cache."""
    batch, prompt_len = prompt.shape
    if prompt_len + length > cache_len:
        raise ValueError(
            f"prompt ({prompt_len}) + length ({length}) exceeds cache ({cache_len})"
        )
    stage = 256
    while stage < prompt_len + 1:
        stage *= 2
    stage = min(stage, cache_len)
    cache, token = _prefill(model, params, prompt, generator, stage, temperature, top_k, top_p)

    chunks = []
    position = prompt_len  # cache slot the next decode step writes
    remaining = length - 1
    while remaining > 0:
        capacity = stage - position
        if capacity <= 0:
            stage = min(max(stage * 2, 256), cache_len)
            cache = _grow_cache(cache, stage)
            continue
        steps = min(remaining, capacity)
        cache, token, tokens = _decode_segment(
            model, params, cache, token, generator, steps, temperature, top_k, top_p
        )
        chunks.append(tokens)
        position += steps
        remaining -= steps
    chunks.append(token[:, None])
    return torch.cat(chunks, dim=1)


def _rnn_generate(model, params, prompt, generator, length: int, temperature, top_k, top_p):
    """MusicRNN decode: the prompt in one forward from zero carries, then one
    one-token forward per event; returns the ``length`` sampled ids."""
    state = rnn_init_state(model.config, prompt.shape[0], device=prompt.device)
    logits, state = _apply(model, params, prompt, state)
    token = sample_filtered_rows(generator, logits[:, -1], temperature, top_k, top_p)
    tokens = [token]
    for _ in range(length - 1):
        logits, state = _apply(model, params, token[:, None], state)
        token = sample_filtered_rows(generator, logits[:, 0], temperature, top_k, top_p)
        tokens.append(token)
    return torch.stack(tokens, dim=1)


def _normalize_sampling(batch: int, temperature, top_k, top_p):
    """Scalar-or-per-row sampling values -> per-row ``(batch,)`` numpy vectors."""
    def vec(value, dtype, name):
        arr = np.asarray(value, dtype).reshape(-1)
        if arr.shape[0] == 1 and batch != 1:
            arr = np.broadcast_to(arr, (batch,))
        if arr.shape[0] != batch:
            raise ValueError(
                f"{name} must be a scalar or a length-{batch} vector, "
                f"got shape {np.asarray(value).shape}"
            )
        return np.ascontiguousarray(arr)

    return (
        vec(temperature, np.float32, "temperature"),
        vec(top_k, np.int32, "top_k"),
        vec(top_p, np.float32, "top_p"),
    )


def _padded_cache_len(cache_len: int) -> int:
    # The kernel's cache rows line up with the JAX package's 128-row padding.
    return max(-(-cache_len // 128) * 128, 128)


def _prefill_min_tokens() -> int:
    """Shortest common prompt prefix that gets a separate prefill forward
    (``COMPOSER_PREFILL_MIN``, default 64; <= 0 disables it)."""
    try:
        return int(os.environ.get("COMPOSER_PREFILL_MIN", "64"))
    except ValueError:
        return 64


class TransformerDecoder:
    """The fused-kernel engine: packs the weights once; each ``generate`` is
    one kernel launch, after an optional prefill forward for long prompts.

    Greedy ids are identical with or without the prefill; sampled streams
    shift, because the kernel's draws start at the prefill's end.
    """

    def __init__(self, model, params=None, dtype=torch.bfloat16):
        self.model = model
        self.config = model.config
        self.params = params
        self.device = _device(model, params)
        self.weights_key = _weights_key(model, params)
        state = params if params is not None else model.state_dict()
        self.packed = dk.pack_weights(state, model.config, dtype=dtype, device=self.device)

    def _prefill_rows(self, prefix, cache_len: int):
        """One batched forward over the shared prompt prefix, exported into
        the kernel's ``(L, B*C, E)`` rows."""
        cache = init_cache(self.config, prefix.shape[0], prefix.shape[1], device=self.device)
        _, cache = _apply(self.model, self.params, prefix, cache)
        return dk.cache_to_rows_batched(cache, self.config, cache_len, self.packed["wte"].dtype)

    def generate(self, prompt, length, temperature=1.0, seed=0, cache_len=None,
                 top_k=0, top_p=0.0, prompt_lengths=None):
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        if cache_len is None:
            cache_len = prompt.shape[1] + length
        cache_len = _padded_cache_len(cache_len)
        temps, topks, topps = _normalize_sampling(prompt.shape[0], temperature, top_k, top_p)
        if prompt_lengths is None:
            plens = np.full(prompt.shape[0], prompt.shape[1], np.int32)
        else:
            plens = np.asarray(prompt_lengths, np.int32).reshape(-1)
            if prompt.shape[0] == 1:
                # Batch 1 is never ragged: trim the padding off the one row.
                prompt = prompt[:, : int(plens[0])]
                plens = np.full(1, prompt.shape[1], np.int32)
        ragged = bool((plens != prompt.shape[1]).any())

        # Parallel prefill for long prompts: one forward covers the common
        # prefix (min prompt length - 1: the last prompt token stays with
        # the kernel, whose step consumes it and samples), bucketed to
        # multiples of 64.
        prefill_min = _prefill_min_tokens()
        start = int(plens.min()) - 1
        if prefill_min <= 0 or start < prefill_min:
            start = 0
        elif start >= 64:
            start = (start // 64) * 64

        greedy, use_k, use_p = dk.sampling_flags(temps, topks, topps)
        tokens = torch.as_tensor(prompt).to(self.device)
        prefill_rows = self._prefill_rows(tokens[:, :start].long(), cache_len) if start else None
        return megakernel_generate_batched(
            self.packed, tokens, seed, temps, config=self.config, length=length,
            cache_len=cache_len, top_k=topks, top_p=topps, greedy=greedy,
            use_k=use_k, use_p=use_p, prompt_lengths=plens if ragged else None,
            prefill_rows=prefill_rows, start_step=start,
        )


class WideTransformerDecoder:
    """The wide-kernel engine: packs the weights once (bf16 on CUDA, float32
    on the CPU); each ``generate`` runs one ``decode_wide`` launch per
    sub-batch of ``_wide_batch_cap`` rows on a carried K/V state.

    ``COMPOSER_WIDE_INT8=1`` packs the streamed matmul weights int8 with
    per-output-channel scales; ``COMPOSER_WIDE_INT8_KV=1`` keeps the K/V
    prefix int8 (bit-identical to float K/V before position 128). Both are
    read at construction. Sub-batch ``i > 0`` samples with seed
    ``(seed * 65537 + 2**16 + i) % 2**31``, as in the JAX package.
    """

    def __init__(self, model, params=None, dtype=None):
        self.model = model
        self.config = model.config
        self.params = params
        self.device = _device(model, params)
        self.weights_key = _weights_key(model, params)
        if dtype is None:
            if os.environ.get("COMPOSER_WIDE_INT8", "0") == "1":
                dtype = torch.int8
            else:
                dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        state = params if params is not None else model.state_dict()
        self.packed = dkw.pack_weights_wide(state, model.config, dtype=dtype, device=self.device)
        self.kv_quant = os.environ.get("COMPOSER_WIDE_INT8_KV", "0") == "1"
        self._kv = {}  # (batch, cache_len) -> the carried K/V state

    def _kv_state(self, batch: int, cache_len: int):
        key = (batch, cache_len)
        if key not in self._kv:
            # One state per dispatch shape, reused across calls: every row a
            # call reads, it wrote first. At the flagship's widths a state is
            # hundreds of MB, so only one shape stays alive.
            self._kv.clear()
            self._kv[key] = dkw.init_kv_state(self.config, batch, cache_len,
                                              self.packed["wte"].dtype, self.kv_quant,
                                              self.device)
        return self._kv[key]

    def generate(self, prompt, length, temperature=1.0, seed=0, cache_len=None,
                 top_k=0, top_p=0.0, prompt_lengths=None):
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        if cache_len is None:
            cache_len = prompt.shape[1] + length
        cache_len = _padded_cache_len(cache_len)
        temps, topks, topps = _normalize_sampling(prompt.shape[0], temperature, top_k, top_p)
        if prompt_lengths is None:
            plens = np.full(prompt.shape[0], prompt.shape[1], np.int32)
        else:
            plens = np.asarray(prompt_lengths, np.int32).reshape(-1)
        chunk = _wide_batch_cap(self.config, cache_len)
        if chunk == 0:
            raise ValueError(
                f"model (embed {self.config.embed_dim}) at cache_len {cache_len} exceeds "
                "the wide kernel's limits; use the xla engine")
        chunk = min(chunk, prompt.shape[0])
        outputs = []
        for index, start in enumerate(range(0, prompt.shape[0], chunk)):
            rows = prompt[start:start + chunk]
            if rows.shape[0] < chunk:  # pad the last sub-batch to the shape
                rows = np.concatenate([rows, np.tile(rows[-1:], (chunk - rows.shape[0], 1))])
            tc, kc, pc, lc = (np.resize(v[start:start + chunk], chunk)
                              for v in (temps, topks, topps, plens))
            chunk_seed = seed if index == 0 else (seed * 65537 + 2**16 + index) % (2**31)
            greedy, use_k, use_p = dk.sampling_flags(tc, kc, pc)
            tokens, _ = dkw.megakernel_generate_wide(
                self.packed, self._kv_state(chunk, cache_len), rows, chunk_seed, tc,
                config=self.config, length=length, cache_len=cache_len, top_k=kc, top_p=pc,
                greedy=greedy, use_k=use_k, use_p=use_p,
                prompt_lengths=lc if bool((lc != rows.shape[1]).any()) else None)
            outputs.append(tokens[:min(chunk, prompt.shape[0] - start)])
        return torch.cat(outputs, dim=0)


def _weights_key(model, params) -> tuple:
    """Storage and version counter of every weight tensor: any in-place
    update (``load_state_dict``, an optimizer step, ``reset_parameters``) or
    move changes it."""
    state = params if params is not None else model.state_dict()
    return tuple((t.data_ptr(), t._version) for t in state.values())


_ENGINE_CACHE: dict = {}
_WIDE_ENGINE_CACHE: dict = {}

# Stats vector of the most recent speculative generate: [total_blocks,
# generation_blocks, final_position, 0...]; the realized acceptance is
# length / generation_blocks.
LAST_SPEC_STATS = None
# Count of speculative dispatches: a caller compares it around a
# generate_ids call to learn whether the spec engine served the request.
SPEC_DISPATCHES = 0


def _packed_engine(model, params) -> TransformerDecoder:
    """One packed engine kept alive, keyed on the model and params objects
    and on their weights' versions, so changed weights are packed anew."""
    engine = _ENGINE_CACHE.get("engine")
    if (engine is None or engine.model is not model or engine.params is not params
            or engine.weights_key != _weights_key(model, params)):
        engine = TransformerDecoder(model, params)
        _ENGINE_CACHE["engine"] = engine
    return engine


def _spec_generate(model, params, prompt, length: int, temps, seed: int, cache_len: int,
                   top_k=0, top_p=0.0):
    """Speculative block decode of one sequence, on the packed weights of the
    fused engine. Returns ``(1, length)`` ids."""
    global LAST_SPEC_STATS, SPEC_DISPATCHES
    engine = _packed_engine(model, params)
    row = np.asarray(prompt, np.int32).reshape(-1)
    tokens, stats = speculative_generate(
        engine.packed, row, seed, temps, config=model.config, length=length,
        cache_len=max(_padded_cache_len(cache_len), row.shape[0] + length),
        top_k=top_k, top_p=top_p,
    )
    LAST_SPEC_STATS = stats.cpu().numpy()
    SPEC_DISPATCHES += 1
    return tokens[None]


def _wide_generate(model, params, prompt, length: int, temps, seed: int, cache_len: int,
                   top_k=0, top_p=0.0, prompt_lengths=None):
    """One packed wide engine kept alive, keyed like ``_packed_engine`` and on
    the two int8 flags, which the engine reads at construction."""
    flags = (os.environ.get("COMPOSER_WIDE_INT8", "0"),
             os.environ.get("COMPOSER_WIDE_INT8_KV", "0"))
    engine = _WIDE_ENGINE_CACHE.get("engine")
    if (engine is None or engine.model is not model or engine.params is not params
            or engine.weights_key != _weights_key(model, params)
            or _WIDE_ENGINE_CACHE.get("flags") != flags):
        _WIDE_ENGINE_CACHE.clear()  # drop the old engine's weights and state first
        engine = WideTransformerDecoder(model, params)
        _WIDE_ENGINE_CACHE.update(engine=engine, flags=flags)
    return engine.generate(prompt, length, temperature=temps, seed=seed, cache_len=cache_len,
                           top_k=top_k, top_p=top_p, prompt_lengths=prompt_lengths)


def _packed_weight_bytes(config) -> int:
    """Bytes of the resident kernels' packed weights, as the JAX package
    counts them: per layer the bf16 matmuls (12 E^2) and the float32 biases
    and LayerNorms, plus the embedding tables (about 12.6 MB for the default
    model, about 200 MB at embed 1024)."""
    e = config.embed_dim
    per_layer = 12 * e * e * 2  # bf16 matmuls
    per_layer += (3 * e + e + 4 * e + e) * 4  # f32 biases
    per_layer += 4 * e * 4  # ln_1/ln_2 scale+bias, f32
    tables = 2 * dk.vocab_pad(config) * e * 2  # wte packed both directions, bf16
    tables += config.window_size * e * 2  # wpe, bf16
    tables += 2 * e * 4  # ln_f, f32
    return config.num_layers * per_layer + tables


# The L2 of the Hopper cards the kernels are built for (sm_90a: H100, H200).
HOPPER_L2_BYTES = 50 * 2**20


def _fast_memory_bytes(device) -> int:
    """The card's L2, where the fused kernel's blocks find the weights they
    re-read at every step. Where PyTorch has no CUDA runtime (a CUDA device
    named in a routing decision on a CPU-only build), the Hopper value."""
    if not torch.cuda.is_available():
        return HOPPER_L2_BYTES
    return torch.cuda.get_device_properties(device).L2_cache_size


def _weights_outgrow_fast_memory(model, device) -> bool:
    return (device.type == "cuda"
            and _packed_weight_bytes(model.config) > _fast_memory_bytes(device))


def _wide_batch_cap(config, cache_len: int) -> int:
    """Largest sub-batch, up to 8, that the wide kernel's limits admit at
    ``cache_len`` (``wide_kernel_fits``: shared memory and widths); 0 where
    none does."""
    for candidate in range(dkw.MAX_BATCH, 0, -1):
        if dkw.wide_kernel_fits(config, candidate, cache_len):
            return candidate
    return 0


def _use_wide_kernel(model, model_type, cache_len: int, engine: str, device) -> bool:
    """``wide`` forces the wide engine (its plain version on the CPU);
    ``auto`` takes it on a CUDA device only where the fused kernel's weights
    would not stay in fast memory, the JAX package's rule with the L2 for
    VMEM."""
    if engine not in ("auto", "wide"):
        return False
    if model_type != ModelType.TRANSFORMER or not model.config.use_layer_norm:
        return False
    if _wide_batch_cap(model.config, _padded_cache_len(cache_len)) == 0:
        return False
    return engine == "wide" or _weights_outgrow_fast_memory(model, device)


def _use_spec_kernel(model, model_type, batch: int, cache_len: int, engine: str, device,
                     temps=None) -> bool:
    """The JAX package's gate for the speculative engine: batch 1 only, a
    transformer with layer norm, a cache the kernel fits. ``spec`` opts in
    for any sampling; ``auto`` only for greedy requests (every temperature
    <= 0) on a CUDA device. Sampled ``auto`` stays sequential: its contract
    is never to run slower than the sequential kernel for any content.

    The greedy route is kept by measurement: on a default model trained
    1156 steps on synthetic tonal music (``scripts/spec_acceptance.py``,
    held-out loss 0.71), the kernel at the greedy block of 5 accepted 3.50
    tokens a block and ran 1.88x the sequential kernel (``generate_ids``
    1.78x) on an H100, where a block costs 1.86 sequential steps; its ids
    are the sequential kernel's, in either type. On content the draft cannot
    predict (random weights, 1.13 tokens a block) it runs 0.61x."""
    greedy = temps is not None and bool(np.all(np.asarray(temps) <= 0))
    if engine == "auto":
        # Resident-weight models only, as in the JAX package.
        if device.type != "cuda" or not greedy or _weights_outgrow_fast_memory(model, device):
            return False
    elif engine != "spec":
        return False
    if model_type != ModelType.TRANSFORMER or batch != 1:
        return False
    if not model.config.use_layer_norm:
        return False
    return spec_kernel_fits(model.config, _padded_cache_len(cache_len), default_block(greedy))


def _use_kernel(model, model_type, cache_len: int, engine: str, device) -> bool:
    if engine not in ("auto", "megakernel", "wide", "xla", "spec"):
        raise ValueError(f"unknown engine {engine!r}")
    # A spec request the speculative engine did not take (batch > 1) goes
    # to the unfused path, as in the JAX package.
    if engine in ("xla", "spec", "wide") or model_type != ModelType.TRANSFORMER:
        return False
    if not model.config.use_layer_norm:
        # The kernel hard-codes the pre-LN block; norm-free models stay unfused.
        return False
    if not kernel_fits(model.config, _padded_cache_len(cache_len)):
        return False
    return engine == "megakernel" or device.type == "cuda"


def _unfused_generate(model, params, prompt_host, plens, length: int, cache_len: int,
                      seed: int, sampling, device):
    """The unfused Transformer path (``engine="xla"``) on host prompts."""
    prompt = torch.as_tensor(prompt_host, device=device).long()
    generator = torch.Generator(device=device).manual_seed(seed)
    warpers = tuple(torch.as_tensor(v, device=device) for v in sampling)
    if plens is not None:
        return _ragged_transformer_generate(model, params, prompt, plens, generator, length,
                                            cache_len, *warpers)
    return _transformer_generate(model, params, prompt, generator, length, cache_len,
                                 *warpers)


def _generation_mesh(model, model_type, mesh, engine: str):
    """The mesh that generation runs on (None for one device); raises for
    an engine that a mesh cannot run."""
    config_mesh = (getattr(model.config, "flash_mesh", None)
                   if model_type == ModelType.TRANSFORMER else None)
    if mesh is not None and config_mesh is not None and mesh is not config_mesh:
        raise ValueError("mesh is not the mesh that the model was built for")
    mesh = mesh if mesh is not None else config_mesh
    if mesh is None or mesh.size == 1:
        return None
    if engine not in ("auto", "xla"):
        raise ValueError(f"engine={engine!r} runs on one device; a mesh generates on the "
                         "unfused path (engine='xla' or 'auto')")
    return mesh


def _mesh_generate(model, model_type, params, prompt_host, plens, length: int,
                   cache_len: int, seed: int, sampling, mesh, device):
    """This rank's rows on the unfused path, gathered over the data group."""
    rows = mesh_lib.local_rows(mesh, prompt_host)
    sampling = tuple(mesh_lib.local_rows(mesh, v) for v in sampling)
    seed = seed + mesh.data_index * 1000003
    if model_type != ModelType.TRANSFORMER:
        generated = _rnn_generate(
            model, params, torch.as_tensor(rows, device=device).long(),
            torch.Generator(device=device).manual_seed(seed), length,
            *(torch.as_tensor(v, device=device) for v in sampling))
    else:
        local_plens = None if plens is None else mesh_lib.local_rows(mesh, plens)
        if local_plens is not None and np.all(local_plens == rows.shape[1]):
            local_plens = None
        generated = _unfused_generate(model, params, rows, local_plens, length, cache_len,
                                      seed, sampling, device)
    return mesh_lib.gather_rows(mesh, generated)


@torch.no_grad()
def generate_ids(model, model_type: ModelType, params_or_variables, prompt_ids,
                 length: int = 1024, temperature: float = 1.0, seed: int = 0,
                 cache_len: Optional[int] = None, engine: str = "auto", top_k: int = 0,
                 top_p: float = 0.0, prompt_lengths=None, mesh=None) -> np.ndarray:
    """Generates ``length`` new event ids after ``prompt_ids``.

    prompt_ids: int array ``[batch, prompt_len]`` (or ``[prompt_len]``).
    Returns ``[batch, prompt_len + length]`` on the host, prompt included.
    ``params_or_variables`` is a ``state_dict`` for ``model`` (MusicRNN's
    with its BatchNorm running statistics) or None for the module's own.

    ``prompt_lengths`` (transformers only): per-row real prompt lengths when
    rows are padded to a common width; row s's generated ids are still
    columns ``[prompt_len, prompt_len + length)``. ``temperature``/``top_k``/
    ``top_p`` are scalars or per-row vectors; a row with temperature <= 0
    decodes greedily. ``engine``: ``auto``, ``spec``, ``megakernel``,
    ``wide`` or ``xla`` (see the module docstring). After a speculative run,
    ``LAST_SPEC_STATS`` holds its stats and ``SPEC_DISPATCHES`` has risen.
    ``mesh``: see the module docstring (a tensor-parallel Transformer's is
    its config's; every rank of the mesh must call this with the same
    arguments, and the batch must divide by the data degree).
    """
    if isinstance(prompt_ids, torch.Tensor):
        prompt_ids = prompt_ids.cpu().numpy()
    prompt_host = np.asarray(prompt_ids, dtype=np.int32)
    squeeze = prompt_host.ndim == 1
    if squeeze:
        prompt_host = prompt_host[None]
    temps, topks, topps = _normalize_sampling(prompt_host.shape[0], temperature, top_k, top_p)
    # Off values normalize to the canonical "disabled" encoding.
    topks = np.where(topks > 0, topks, 0)
    topps = np.where((topps > 0.0) & (topps < 1.0), topps, 0.0).astype(np.float32)

    plens = None
    if prompt_lengths is not None:
        if model_type != ModelType.TRANSFORMER:
            raise ValueError("prompt_lengths is only supported for transformers")
        plens = np.asarray(prompt_lengths, np.int32).reshape(-1)
        if np.all(plens == prompt_host.shape[1]):
            plens = None  # uniform: the fixed-length paths

    if cache_len is None:
        cache_len = prompt_host.shape[1] + length
    device = _device(model, params_or_variables)
    mesh = _generation_mesh(model, model_type, mesh, engine)
    if mesh is not None:
        generated = _mesh_generate(model, model_type, params_or_variables, prompt_host, plens,
                                   length, cache_len, seed, (temps, topks, topps), mesh, device)
    elif model_type != ModelType.TRANSFORMER:
        generated = _rnn_generate(
            model, params_or_variables, torch.as_tensor(prompt_host, device=device).long(),
            torch.Generator(device=device).manual_seed(seed), length,
            *(torch.as_tensor(v, device=device) for v in (temps, topks, topps)))
    elif _use_spec_kernel(model, model_type, prompt_host.shape[0], cache_len, engine, device,
                        temps):
        prompt = prompt_host if plens is None else prompt_host[:, :int(plens[0])]
        generated = _spec_generate(model, params_or_variables, prompt, length, temps, seed,
                                   cache_len, top_k=topks, top_p=topps)
    elif _use_wide_kernel(model, model_type, cache_len, engine, device):
        generated = _wide_generate(model, params_or_variables, prompt_host, length, temps,
                                   seed, cache_len, top_k=topks, top_p=topps,
                                   prompt_lengths=plens)
    elif _use_kernel(model, model_type, cache_len, engine, device):
        generated = _packed_engine(model, params_or_variables).generate(
            prompt_host, length, temperature=temps, seed=seed,
            cache_len=cache_len, top_k=topks, top_p=topps, prompt_lengths=plens,
        )
    else:
        generated = _unfused_generate(model, params_or_variables, prompt_host, plens, length,
                                      cache_len, seed, (temps, topks, topps), device)

    result = np.concatenate([prompt_host, generated.cpu().numpy().astype(np.int32)], axis=1)
    return result[0] if squeeze else result
