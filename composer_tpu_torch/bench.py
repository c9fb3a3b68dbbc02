"""Benchmark harness of the port.

    python -m composer_tpu_torch.bench             # every workload, on the card
    python -m composer_tpu_torch.bench headline    # the one line of the root bench.py

The port of ``composer_tpu/bench.py``: each ``run_*`` is the counterpart of
the JAX function of the same name, with its arguments, defaults, metric and
unit, through the port's engines (``generate_ids``, ``GenerationService``,
``ContinuousGenerationService``, ``Trainer``, the preprocessing pipeline).
``run_all`` runs the JAX table's rows, names and order; ``headline`` is the
counterpart of the root ``bench.py``: 8 x 1014 events, with ``detail.batch1``
at 1 x 1024.

Every function takes ``device``: the card unless the caller asks for the CPU,
where the kernels' plain versions run at the tiny shapes of the tests. A
device number (``on_device_seconds``, the marginal rates, ``pct_peak_bf16``)
comes only from the card and is None on the CPU.

What differs from the JAX package:

* on-device time is read off CUDA events inside the wall-clock window of
  the fastest timed call (``_timed_calls``): the device's timeline of the
  call, not a sum of kernel times;
* ``vs_baseline`` of the decode, serving and speculative rows is None: the
  JAX package's decode target is a TPU's, and the port has none on the
  card until its benchmark sets one. Train rows keep tokens/s and the
  preprocess row files/s, as in the JAX package;
* ``detail`` names the ``backend`` (``cuda`` or ``cpu``), on the card the
  card's name and power limit (``card``, from ``nvidia-smi``), and for the
  decode and serving rows the kernels that ran: ``launches``, the rise of
  each wrapper's count (``ops.launch_counts``), so that a route to the
  unfused path shows as a row without launches;
* train rows synchronise the device before each clock read, report
  ``attention`` as ``flash`` or ``plain`` (the port has no band or chunked
  path: ``attention_chunk_size`` is taken and ignored), the last step's
  loss and, on the card, the peak device memory;
* ``run_speculative_benchmark`` runs the speculative kernel's plain version
  on the CPU, where the JAX package refuses;
* a request that fails in a serving row fails the row;
* ``run_all`` writes its markdown only to the path the caller names
  (``__main__``: ``build/bench/BENCHMARKS.md``).
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from composer_tpu_torch.ops import launch_counts

REPO = Path(__file__).resolve().parent.parent
DEFAULT_MARKDOWN = REPO / "build" / "bench" / "BENCHMARKS.md"


def _device(device) -> torch.device:
    """``device`` as a ``torch.device``; the card must exist when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on the card, and torch sees no CUDA device here; "
                           "pass device='cpu' to run the plain versions")
    return device


def _dtype(device: torch.device) -> torch.dtype:
    """bf16 weights and compute on the card, float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _backend(device: torch.device) -> dict:
    detail = {"backend": device.type}
    if device.type == "cuda":
        detail["card"] = card_line()
    return detail


def _launches_since(before: dict) -> dict:
    """Each kernel wrapper's launches since ``before`` (``launch_counts()``),
    those that rose only."""
    return {name: count - before.get(name, 0) for name, count in launch_counts().items()
            if count != before.get(name, 0)}


def _timed_once(call):
    start = time.perf_counter()
    call()
    return time.perf_counter() - start


def _timed_calls(call, device: torch.device, repeats: int):
    """``(wall seconds, on-device seconds)`` of the fastest of ``repeats``
    calls. On-device seconds are read off CUDA events recorded on the current
    stream inside that call's wall-clock window, so they never exceed its
    wall time: the device's timeline from the call's start to its end, for a
    call that runs one kernel that kernel's time with the call's host set-up,
    fills and copies. None off the card. ``torch.profiler``'s device
    activity is not used: on the card it recorded only some of these
    kernels' launches, and none in some runs."""
    best, best_device = float("inf"), None
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            _sync(device)
        begin = time.perf_counter()
        if device.type == "cuda":
            start.record()
        call()
        if device.type == "cuda":
            end.record()
            end.synchronize()
        wall = time.perf_counter() - begin
        if wall < best:
            best = wall
            best_device = start.elapsed_time(end) / 1e3 if device.type == "cuda" else None
    return best, best_device


def _device_seconds_per_call(call, device: torch.device, calls: int = 3):
    """On-device seconds of the fastest of ``calls`` calls (``_timed_calls``);
    None off the card."""
    return _timed_calls(call, device, calls)[1]


# The card's published dense peaks (NVIDIA's data sheet, at the full power
# limit), keyed by torch.cuda.get_device_name(): bf16 tensor-core TFLOP/s and
# HBM GB/s, for the train rows' roofline column.
_CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_gbps": 3350.0},  # H100 SXM
}


def _chip_peaks(device: torch.device):
    if device.type != "cuda":
        return None
    return _CHIP_PEAKS.get(torch.cuda.get_device_name(device))


def _transformer_train_tflops(batch_size, window_size, embed_dim, num_heads,
                              num_layers, vocab_size=390, relative=True,
                              ffw_mult=4):
    """Matmul TFLOPs one training step issues to the tensor cores.

    Counts full S x S attention matmuls (causal masking discards half the
    products, but the plain path computes them all; flash skips fully masked
    tiles but revisits tiles in its backward, so full S^2 stays the common
    count) with the convention backward = 2 x forward. Relative attention
    adds the Q @ E^T band term, a third S^2-by-depth matmul per head.
    """
    tokens = batch_size * window_size
    # Per-token fwd: QKV+output projections (4 x 2E^2) + MLP (2 x 2E*4E).
    proj = num_layers * (8 + 4 * ffw_mult) * embed_dim ** 2
    # Attention scores + AV (+ rel bias): 2/3 matmuls of 2*S*E per token.
    attn = num_layers * (6 if relative else 4) * window_size * embed_dim
    logits = 2 * embed_dim * vocab_size  # tied-wte readout
    fwd = tokens * (proj + attn + logits)
    return 3 * fwd / 1e12  # fwd + 2x bwd


def _rnn_train_tflops(batch_size, window_size, embed_dim=256,
                      layer_sizes=(512, 512, 512), vocab_size=390):
    """Matmul TFLOPs per MusicRNN training step (4 gates per LSTM layer)."""
    tokens = batch_size * window_size
    flops, fan_in = 0, embed_dim
    for size in layer_sizes:
        flops += 8 * size * (fan_in + size)  # 2 * 4H * (I + H)
        fan_in = size
    flops += 2 * fan_in * vocab_size
    return 3 * tokens * flops / 1e12


def _roofline(tflops_per_step, elapsed_seconds, device: torch.device):
    """Achieved TFLOP/s (+ % of the card's bf16 peak when known)."""
    achieved = tflops_per_step / elapsed_seconds
    out = {"tflops_per_sec": round(achieved, 2)}
    peaks = _chip_peaks(device)
    if peaks:
        out["pct_peak_bf16"] = round(100 * achieved / peaks["bf16_tflops"], 1)
    return out


def _default_transformer(use_relative_attention: bool, dtype, embed_dim=256,
                         window_size=1024, num_layers=8, *, seed=0, device="cuda"):
    """The default architecture (vocab 390, 16 heads) for serving: weights in
    ``dtype`` too, random from ``seed``, in eval mode on ``device``."""
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig

    config = TransformerConfig(
        vocab_size=390,
        embed_dim=embed_dim,
        window_size=window_size,
        num_layers=num_layers,
        num_heads=16,
        use_relative_attention=use_relative_attention,
        attention_dropout_rate=0.0,
        residual_dropout_rate=0.0,
        dtype=dtype,
        param_dtype=dtype,
    )
    model = Transformer(config)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def _music_rnn(seed: int, device: torch.device):
    from composer_tpu_torch.models.music_rnn import MusicRNN, MusicRNNConfig

    model = MusicRNN(MusicRNNConfig(vocab_size=390))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def run_decode_benchmark(
    length: int = 1024,
    batch_size: int = 1,
    prompt_length: int = 10,
    use_relative_attention: bool = False,
    dtype=None,
    repeats: int = 3,
    seed: int = 0,
    embed_dim: int = 256,
    engine: str = "auto",
    device="cuda",
):
    """Times ``generate_ids``, the KV-cached decode; returns the bench JSON dict.

    ``embed_dim``/``engine`` cover the wide-model serving path: models whose
    packed weights outgrow the card's L2 (embed 1024, about 200 MB:
    ``train/generate.py::_packed_weight_bytes``) decode through the wide
    kernel under ``auto``; ``engine="xla"`` is the unfused path.
    """
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.train.generate import generate_ids

    device = _device(device)
    dtype = dtype or _dtype(device)
    model = _default_transformer(use_relative_attention, dtype, embed_dim, seed=seed,
                                 device=device)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 390, (batch_size, prompt_length)).astype(np.int32)
    before = launch_counts()

    def make_call(gen_length, cache_len=None):
        def call():
            # Host ids: the call returns after the device has finished.
            return generate_ids(
                model, ModelType.TRANSFORMER, None, prompt,
                length=gen_length, temperature=1.0, seed=seed,
                cache_len=cache_len, engine=engine,
            )

        return call

    call = make_call(length)
    call()  # build the kernel, pack the weights, warm up
    best, device_seconds = _timed_calls(call, device, repeats)

    # On-device marginal rate: device time at two lengths, differenced, so
    # that the fixed per-call work (set-up, prefill, copies) cancels and
    # only the per-event cost remains. Both lengths run against the same
    # cache, so each step costs the same. The full-call device time is
    # reported for every batch size, the marginal for the batch-1 latency
    # workload.
    marginal = None
    if batch_size == 1 and device_seconds:
        short = max(length // 2, 1)
        short_seconds = _device_seconds_per_call(make_call(short, prompt_length + length), device)
        if short_seconds and device_seconds > short_seconds:
            marginal = round(
                batch_size * (length - short) / (device_seconds - short_seconds), 1
            )

    events_per_sec = batch_size * length / best
    return {
        "metric": "decode_events_per_sec",
        "value": round(events_per_sec, 1),
        "unit": "events/sec/chip",
        "vs_baseline": None,
        "detail": {
            "length": length,
            "batch_size": batch_size,
            "relative_attention": use_relative_attention,
            **({"embed_dim": embed_dim} if embed_dim != 256 else {}),
            **({"engine": engine} if engine != "auto" else {}),
            **_backend(device),
            "dtype": _dtype_name(dtype),
            "seconds": round(best, 4),
            "on_device_seconds": round(device_seconds, 4) if device_seconds else None,
            "on_device_events_per_sec_marginal": marginal,
            "launches": _launches_since(before),
        },
    }


def run_wide_int8_decode_benchmark(batch_size: int = 8, length: int = 1014,
                                   embed_dim: int = 1024, device="cuda"):
    """int8 streaming wide decode (``COMPOSER_WIDE_INT8`` packing).

    Same workload as the bf16 wide row; the detail carries the analytic
    per-step HBM weight-stream sizes, so that the table shows what the int8
    packing buys (the stream is the wide kernel's largest cost). The wide
    engine's cache key holds the flag, so the row packs its own weights.
    """
    os.environ["COMPOSER_WIDE_INT8"] = "1"
    try:
        result = run_decode_benchmark(
            batch_size=batch_size, length=length, embed_dim=embed_dim,
            engine="wide", repeats=2, device=device,
        )
    finally:
        os.environ.pop("COMPOSER_WIDE_INT8", None)
    weight_elems = 12 * embed_dim * embed_dim * 8  # matmul blocks, 8 layers
    result["detail"]["int8"] = True
    result["detail"]["weight_stream_mb_per_step"] = round(weight_elems / 1e6, 1)
    result["detail"]["weight_stream_mb_per_step_bf16"] = round(2 * weight_elems / 1e6, 1)
    return result


def run_wide_int8_kv_decode_benchmark(batch_size: int = 8,
                                      length: int = 1014,
                                      embed_dim: int = 1024, device="cuda"):
    """int8 K/V streaming wide decode (``COMPOSER_WIDE_INT8_KV``).

    Same workload as the bf16 wide row with the K/V prefix kept int8. The
    detail carries the analytic K/V prefix stream at the mean live prefix
    (about length/2 rows): the second-largest HBM term after the weights,
    halved by the packing.
    """
    os.environ["COMPOSER_WIDE_INT8_KV"] = "1"
    try:
        result = run_decode_benchmark(
            batch_size=batch_size, length=length, embed_dim=embed_dim,
            engine="wide", repeats=2, device=device,
        )
    finally:
        os.environ.pop("COMPOSER_WIDE_INT8_KV", None)
    layers, live = 8, length // 2
    kv_elems = layers * live * 2 * batch_size * embed_dim
    result["detail"]["int8_kv"] = True
    result["detail"]["kv_stream_mb_per_step"] = round(kv_elems / 1e6, 1)
    result["detail"]["kv_stream_mb_per_step_bf16"] = round(2 * kv_elems / 1e6, 1)
    return result


def run_batched_decode_benchmark(
    batch_size: int = 64,
    length: int = 2048,
    prompt_length: int = 10,
    dtype=None,
    repeats: int = 2,
    seed: int = 0,
    engine: str = "auto",
    use_relative_attention: bool = False,
    device="cuda",
):
    """Batched prompted continuation (BASELINE.md row 2). 10 + 2048 events
    pass the window of 1024: positions beyond it take the last learned
    position embedding, as in the JAX package. On the card ``auto`` runs the
    whole batch in one ``decode_generate`` launch where the kernel admits the
    cache (``kernel_fits``); pass ``engine="xla"`` for the unfused path."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.train.generate import generate_ids

    device = _device(device)
    dtype = dtype or _dtype(device)
    model = _default_transformer(use_relative_attention, dtype, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 390, (batch_size, prompt_length)).astype(np.int32)
    before = launch_counts()

    def run():
        return generate_ids(
            model, ModelType.TRANSFORMER, None, prompt,
            length=length, temperature=1.0, seed=seed, engine=engine,
        )

    run()
    best = min(_timed_once(run) for _ in range(repeats))
    events_per_sec = batch_size * length / best
    return {
        "metric": "batched_decode_events_per_sec",
        "value": round(events_per_sec, 1),
        "unit": "events/sec/chip",
        "vs_baseline": None,
        "detail": {
            "batch_size": batch_size, "length": length, "engine": engine,
            "relative_attention": use_relative_attention,
            "seconds": round(best, 3), **_backend(device),
            "launches": _launches_since(before),
        },
    }


def run_rnn_decode_benchmark(length: int = 1024, batch_size: int = 8, repeats: int = 3,
                             seed: int = 0, device="cuda"):
    """MusicRNN stateful decode throughput: ``generate_ids``' LSTM path, one
    forward and one sampling call an event (no TPU kernel lies on it)."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.train.generate import generate_ids

    device = _device(device)
    model = _music_rnn(seed, device).eval()
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 390, (batch_size, 10)).astype(np.int32)

    def make_call(gen_length):
        def call():
            return generate_ids(
                model, ModelType.MUSIC_RNN, None, prompt,
                length=gen_length, temperature=1.0, seed=seed,
            )

        return call

    call = make_call(length)
    call()
    best, long_seconds = _timed_calls(call, device, repeats)
    events_per_sec = batch_size * length / best

    # Length-differenced on-device marginal, on the card only.
    marginal = None
    if device.type == "cuda":
        short = length // 2
        short_call = make_call(short)
        short_call()
        short_seconds = _device_seconds_per_call(short_call, device)
        if long_seconds and short_seconds and long_seconds > short_seconds:
            marginal = round(
                batch_size * (length - short) / (long_seconds - short_seconds), 1
            )

    return {
        "metric": "rnn_decode_events_per_sec",
        "value": round(events_per_sec, 1),
        "unit": "events/sec/chip",
        "vs_baseline": None,
        "detail": {
            "length": length, "batch_size": batch_size,
            "seconds": round(best, 4), **_backend(device),
            "on_device_events_per_sec_marginal": marginal,
        },
    }


def run_speculative_benchmark(
    length: int = 1014,
    prompt_length: int = 10,
    repeats: int = 3,
    seed: int = 0,
    restoredir: str = None,
    device="cuda",
):
    """Batch-1 speculative block decode against the sequential kernel.

    Speculative throughput depends on acceptance, so three regimes are
    measured (each an on-device marginal, by length differencing):

    * ``floor``: temperature-1.0 sampling on random weights: the stream is
      near uniform, the n-gram draft almost never hits, and every block
      pays the verify cost for about 1 token. The engine's worst case.
    * ``cycle``: greedy on random weights: random transformers fall into
      short cycles the lookup predicts perfectly; an upper bound.
    * ``trained_greedy`` / ``trained_sampled`` (when ``restoredir`` or
      ``$COMPOSER_SPEC_RESTOREDIR`` names a trained logdir of the port): the
      rates on a real model, greedy (the configuration ``auto`` routes to
      the speculative kernel) and temperature-0.9 sampling (which ``auto``
      keeps sequential).

    The headline ``value`` is the trained greedy marginal when there is one,
    else the floor (never the cycle: it flatters); None off the card, where
    the plain versions run and no device time exists. ``repeats`` is taken
    for the JAX package's signature; each regime runs its calls once.
    """
    from composer_tpu_torch.ops import decode_kernel as dk
    from composer_tpu_torch.ops import decode_kernel_spec as dks
    from composer_tpu_torch.train.generate import _padded_cache_len

    del repeats
    device = _device(device)
    dtype = _dtype(device)
    restoredir = restoredir or os.environ.get("COMPOSER_SPEC_RESTOREDIR")
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 390, prompt_length).astype(np.int32)
    before = launch_counts()

    def differenced(make_run):
        short = length // 2
        long_run, short_run = make_run(length), make_run(short)
        first = long_run()
        short_run()
        long_s = _device_seconds_per_call(long_run, device)
        short_s = _device_seconds_per_call(short_run, device)
        marginal = None
        if long_s and short_s and long_s > short_s:
            marginal = round((length - short) / (long_s - short_s), 1)
        return marginal, first

    def measure(config, packed, temperature, pr):
        cache = _padded_cache_len(int(pr.shape[0]) + length)

        def make_run(gen_len):
            def run():
                tokens, stats = dks.speculative_generate(
                    packed, pr, seed, temperature,
                    config=config, length=gen_len, cache_len=cache,
                )
                return tokens.cpu().numpy(), stats.cpu().numpy()
            return run

        marginal, (_, stats) = differenced(make_run)
        gen_blocks = max(int(stats[1]), 1)
        return marginal, round(length / gen_blocks, 2)

    def seq_marginal(config, packed, temperature, pr):
        cache = _padded_cache_len(int(pr.shape[0]) + length)

        def make_run(gen_len):
            def run():
                return dk.megakernel_generate(
                    packed, pr, seed, temperature,
                    config=config, length=gen_len, cache_len=cache,
                ).cpu().numpy()
            return run

        return differenced(make_run)[0]

    model = _default_transformer(False, dtype, seed=seed, device=device)
    packed = dk.pack_weights(model.state_dict(), model.config, dtype=dtype, device=device)

    detail = {
        "length": length, "prompt_length": prompt_length,
        **_backend(device),
        "block_greedy": dks.default_block(True),
        "block_sampled": dks.default_block(False),
    }
    floor_m, floor_acc = measure(model.config, packed, 1.0, prompt)
    cycle_m, cycle_acc = measure(model.config, packed, 0.0, prompt)
    detail["floor"] = {
        "on_device_marginal": floor_m, "tokens_per_block": floor_acc,
        "temperature": 1.0,
    }
    detail["cycle"] = {
        "on_device_marginal": cycle_m, "tokens_per_block": cycle_acc,
        "temperature": 0.0,
    }
    detail["sequential_on_device_marginal"] = seq_marginal(model.config, packed, 1.0, prompt)

    value = floor_m
    if restoredir:
        from composer_tpu_torch.cli import _make_trainer, get_config_from_restoredir
        from composer_tpu_torch.models import ModelType, get_batch_size, get_window_size

        config = get_config_from_restoredir(restoredir)
        trainer = _make_trainer(ModelType.TRANSFORMER, config)
        state = trainer.restore(
            restoredir,
            get_batch_size(ModelType.TRANSFORMER, config),
            get_window_size(ModelType.TRANSFORMER, config),
        )
        tconfig = trainer.model.config
        tpacked = dk.pack_weights(state.model.state_dict(), tconfig, dtype=dtype, device=device)
        greedy_m, greedy_acc = measure(tconfig, tpacked, 0.0, prompt)
        trained_m, trained_acc = measure(tconfig, tpacked, 0.9, prompt)
        detail["trained_greedy"] = {
            "on_device_marginal": greedy_m, "tokens_per_block": greedy_acc,
            "temperature": 0.0, "restoredir": str(restoredir),
        }
        detail["trained_sampled"] = {
            "on_device_marginal": trained_m, "tokens_per_block": trained_acc,
            "temperature": 0.9,
        }
        detail["sequential_trained_greedy_marginal"] = seq_marginal(tconfig, tpacked, 0.0, prompt)
        value = greedy_m
    detail["launches"] = _launches_since(before)

    return {
        "metric": "speculative_decode_events_per_sec",
        "value": value,
        "unit": "events/sec/chip (on-device marginal)",
        "vs_baseline": None,
        "detail": detail,
    }


def _run_clients(target, args_list) -> None:
    """``target(*args)`` on a thread each, all started, then joined; raises
    the first exception a client raised."""
    errors = []

    def client(*args):
        try:
            target(*args)
        except Exception as error:  # re-raised below, on the caller's thread
            errors.append(error)

    threads = [threading.Thread(target=client, args=args) for args in args_list]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]


def run_serving_benchmark(
    concurrency: int = 32,
    length: int = 1014,
    prompt_length: int = 10,
    max_batch_size: int = 8,
    dtype=None,
    seed: int = 0,
    mixed_sampling: bool = False,
    use_relative_attention: bool = False,
    device="cuda",
):
    """Coalesced serving throughput (the ``serve`` data plane).

    ``concurrency`` client threads block on ``GenerationService.submit``;
    the service's one device worker coalesces requests into batches of up
    to ``max_batch_size`` and runs each through ``generate_ids`` (on the
    card the fused batched decode kernel). Measures aggregate generated
    events/s across the burst, queueing and padding included.

    ``mixed_sampling`` gives every client its own temperature/top-k/top-p
    (one greedy client in 8): heterogeneous traffic that still coalesces,
    because the sampling values are per-row kernel operands.
    """
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.serving import GenerationService

    device = _device(device)
    dtype = dtype or _dtype(device)
    model = _default_transformer(use_relative_attention, dtype, seed=seed, device=device)
    service = GenerationService(
        model, ModelType.TRANSFORMER, None, vocab_size=390,
        max_batch_size=max_batch_size, seed=seed, device=device,
    )
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, 390, (concurrency, prompt_length)).astype(np.int32)
    if mixed_sampling:
        sampling = [
            {
                "temperature": 0.0 if index % 8 == 7
                else round(0.7 + 0.05 * (index % 8), 2),
                "top_k": int(5 + index % 13) if index % 3 == 0 else 0,
                "top_p": round(0.85 + 0.01 * (index % 10), 2)
                if index % 3 == 1 else 0.0,
            }
            for index in range(concurrency)
        ]
    else:
        sampling = [{} for _ in range(concurrency)]

    def submit(index):
        service.submit(prompts[index], length, **sampling[index])

    def burst():
        _run_clients(submit, [(index,) for index in range(concurrency)])

    before = launch_counts()
    try:
        # The warm-up burst builds and packs; the timed burst then runs warm.
        burst()
        warmup_batches = len(service.batch_sizes)
        start = time.perf_counter()
        burst()
        elapsed = time.perf_counter() - start
    finally:
        batch_sizes = list(service.batch_sizes)
        service.close()
    timed_batches = batch_sizes[warmup_batches:]

    events_per_sec = concurrency * length / elapsed
    return {
        "metric": "serving_events_per_sec",
        "value": round(events_per_sec, 1),
        "unit": "events/sec/chip",
        "vs_baseline": None,
        "detail": {
            "concurrency": concurrency, "length": length,
            "max_batch_size": max_batch_size, "seconds": round(elapsed, 3),
            "coalesced_batches": timed_batches,
            "mixed_sampling": mixed_sampling,
            "relative_attention": use_relative_attention,
            **_backend(device),
            "launches": _launches_since(before),
        },
    }


def _poisson_schedule(seed: int, requests: int, mean_interarrival_ms: float, lengths):
    """Arrival gaps (seconds), prompts and generation lengths of a Poisson
    run, drawn in the JAX package's order (``composer_tpu/bench.py:765-771``),
    so that one seed gives both packages the same traffic."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mean_interarrival_ms / 1000.0, requests)
    plens = rng.integers(8, 65, requests)
    prompts = [rng.integers(0, 390, p).astype(np.int32) for p in plens]
    req_lengths = [int(lengths[i % len(lengths)]) for i in range(requests)]
    return gaps, prompts, req_lengths


def run_poisson_serving_benchmark(
    continuous: bool = True,
    requests: int = 40,
    mean_interarrival_ms: float = 40.0,
    length: int = 256,
    lengths=None,
    slots: int = 8,
    seg_steps: int = 64,
    dtype=None,
    seed: int = 0,
    embed_dim: int = 256,
    num_layers: int = 8,
    cache_len: int = 1024,
    temperature: float = 0.8,
    device="cuda",
):
    """Request latency under Poisson arrivals: run-to-completion batching
    against continuous batching.

    Clients arrive with exponential inter-arrival gaps, ragged prompt
    lengths and (with ``lengths``) mixed generation lengths; each request's
    latency is completion - arrival. The run-to-completion coalescer makes a
    late arrival wait out the running batch's whole generation; the
    continuous scheduler admits it at the next segment boundary. Both modes
    get the same arrival schedule and request mix (same seed). The
    continuous detail reports slot occupancy (mean/max active rows per
    segment run).
    """
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.serving import ContinuousGenerationService, GenerationService

    device = _device(device)
    dtype = dtype or _dtype(device)
    model = _default_transformer(
        False, dtype, embed_dim=embed_dim, num_layers=num_layers, seed=seed, device=device
    )
    if continuous:
        service = ContinuousGenerationService(
            model, ModelType.TRANSFORMER, None, vocab_size=390,
            slots=slots, seg_steps=seg_steps, cache_len=cache_len, seed=seed, device=device,
        )
    else:
        service = GenerationService(
            model, ModelType.TRANSFORMER, None, vocab_size=390,
            max_batch_size=slots, seed=seed, device=device,
        )

    if lengths is None:
        lengths = (length,)
    gaps, prompts, req_lengths = _poisson_schedule(seed, requests, mean_interarrival_ms,
                                                   lengths)
    latencies = [0.0] * requests
    errors = []

    def client(index, timed):
        start = time.perf_counter()
        try:
            service.submit(prompts[index], req_lengths[index], temperature=temperature)
        except Exception as error:  # re-raised below, on the caller's thread
            errors.append(error)
            return
        if timed:
            latencies[index] = time.perf_counter() - start

    def run_schedule(timed: bool):
        threads = []
        begin = time.perf_counter()
        for index in range(requests):
            time.sleep(gaps[index])
            thread = threading.Thread(target=client, args=(index, timed))
            thread.start()
            threads.append(thread)
        for thread in threads:
            thread.join()
        if errors:
            raise errors[0]
        return time.perf_counter() - begin

    before = launch_counts()
    try:
        # A full untimed pass of the same schedule first: it builds the
        # kernels, packs the weights and warms the service's paths.
        run_schedule(timed=False)
        warm_segments = len(service.batch_sizes)
        elapsed = run_schedule(timed=True)
    finally:
        occupancy = list(service.batch_sizes)
        service.close()
    occupancy = [o for o in occupancy[warm_segments:] if o > 0]

    lat = np.sort(np.asarray(latencies))
    p50 = float(lat[int(0.50 * (requests - 1))])
    p95 = float(lat[int(0.95 * (requests - 1))])
    total_events = sum(req_lengths)
    events_per_sec = total_events / elapsed
    # Offered load: mean events requested per second of arrivals.
    offered = float(np.mean(req_lengths)) / (mean_interarrival_ms / 1000.0)
    return {
        "metric": "poisson_serving_p95_seconds",
        "value": round(p95, 4),
        "unit": "s",
        "vs_baseline": None,
        "detail": {
            "mode": "continuous" if continuous else "run-to-completion",
            "requests": requests,
            "lengths": list(lengths) if len(lengths) > 1 else lengths[0],
            "mean_interarrival_ms": mean_interarrival_ms,
            "offered_events_per_sec": round(offered, 1),
            "p50_s": round(p50, 4), "p95_s": round(p95, 4),
            "mean_s": round(float(lat.mean()), 4),
            "events_per_sec": round(events_per_sec, 1),
            **(
                {
                    "occupancy_mean": round(float(np.mean(occupancy)), 2),
                    "occupancy_max": int(max(occupancy)),
                }
                if continuous and occupancy
                else {}
            ),
            "slots": slots, "seg_steps": seg_steps,
            **({"embed_dim": embed_dim} if embed_dim != 256 else {}),
            **_backend(device),
            "launches": _launches_since(before),
        },
    }


def run_overload_soak_benchmark(
    duration_s: float = 60.0,
    mean_interarrival_ms: float = 8.0,
    lengths=(128, 256, 384),
    slots: int = 8,
    seg_steps: int = 64,
    max_queue_depth: int = 16,
    deadline_ms: float = 8000.0,
    dtype=None,
    seed: int = 0,
    embed_dim: int = 256,
    num_layers: int = 8,
    cache_len: int = 1024,
    temperature: float = 0.8,
    device="cuda",
):
    """Sustained overload: Poisson arrivals offering more events/s than the
    continuous engine serves, for ``duration_s``, with the overload
    controls on (a bounded queue rejects, a per-request deadline expires).

    Shows that the service degrades predictably instead of queueing without
    bound: completed requests keep a bounded p95, the excess is rejected at
    the door (the 429 of the HTTP layer) or expires at its deadline, and the
    queue gauge returns to zero afterwards.
    """
    from composer_tpu_torch.exceptions import DeadlineExceededError, ServiceOverloadedError
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.serving import ContinuousGenerationService

    device = _device(device)
    dtype = dtype or _dtype(device)
    model = _default_transformer(
        False, dtype, embed_dim=embed_dim, num_layers=num_layers, seed=seed, device=device
    )
    service = ContinuousGenerationService(
        model, ModelType.TRANSFORMER, None, vocab_size=390,
        slots=slots, seg_steps=seg_steps, cache_len=cache_len, seed=seed,
        max_queue_depth=max_queue_depth, default_deadline_ms=deadline_ms, device=device,
    )

    rng = np.random.default_rng(seed)
    lock = threading.Lock()
    completed_latencies = []
    counts = {"completed": 0, "rejected": 0, "expired": 0, "other": 0}

    def client(prompt, length):
        start = time.perf_counter()
        try:
            service.submit(prompt, length, temperature=temperature)
        except ServiceOverloadedError:
            outcome = "rejected"
        except DeadlineExceededError:
            outcome = "expired"
        except Exception:  # counted, and reported as other_errors
            outcome = "other"
        else:
            outcome = "completed"
        with lock:
            counts[outcome] += 1
            if outcome == "completed":
                completed_latencies.append(time.perf_counter() - start)

    before = launch_counts()
    try:
        # Warm the service at each length before the soak, with a deadline
        # no warm-up request can reach.
        for length in sorted(set(lengths)):
            service.submit(
                rng.integers(0, 390, 16).astype(np.int32), length,
                temperature=temperature, deadline_ms=3_600_000,
            )
        threads = []
        begin = time.perf_counter()
        index = 0
        while time.perf_counter() - begin < duration_s:
            time.sleep(float(rng.exponential(mean_interarrival_ms / 1000.0)))
            prompt = rng.integers(0, 390, int(rng.integers(8, 65))).astype(np.int32)
            length = int(lengths[index % len(lengths)])
            thread = threading.Thread(target=client, args=(prompt, length))
            thread.start()
            threads.append(thread)
            index += 1
        offered = index / (time.perf_counter() - begin)
        for thread in threads:
            thread.join()
        elapsed = time.perf_counter() - begin
        stats = service.overload_stats()
    finally:
        service.close()

    lat = np.sort(np.asarray(completed_latencies)) if completed_latencies else np.zeros(1)
    total = max(index, 1)
    goodput = counts["completed"] * float(np.mean(lengths)) / elapsed
    return {
        "metric": "overload_soak_p95_seconds",
        "value": round(float(lat[int(0.95 * (len(lat) - 1))]), 4),
        "unit": "s",
        "vs_baseline": None,
        "detail": {
            "duration_s": round(elapsed, 1),
            "offered_requests_per_sec": round(offered, 1),
            "mean_interarrival_ms": mean_interarrival_ms,
            "lengths": list(lengths),
            "requests": total,
            "completed": counts["completed"],
            "rejected": counts["rejected"],
            "expired": counts["expired"],
            "other_errors": counts["other"],
            "reject_rate": round(counts["rejected"] / total, 3),
            "expire_rate": round(counts["expired"] / total, 3),
            "p50_s": round(float(lat[int(0.50 * (len(lat) - 1))]), 4),
            "p95_s": round(float(lat[int(0.95 * (len(lat) - 1))]), 4),
            "goodput_events_per_sec": round(goodput, 1),
            "max_queue_depth": max_queue_depth,
            "deadline_ms": deadline_ms,
            "final_queue_depth": stats["queue_depth"],
            "slots": slots, "seg_steps": seg_steps,
            **_backend(device),
            "launches": _launches_since(before),
        },
    }


def run_long_prompt_serving_benchmark(
    prompt_len: int = 512,
    length: int = 256,
    requests: int = 8,
    slots: int = 8,
    seg_steps: int = 64,
    prefill: bool = True,
    dtype=None,
    seed: int = 0,
    embed_dim: int = 256,
    num_layers: int = 8,
    cache_len: int = 1024,
    temperature: float = 0.8,
    prefill_min: int = 128,
    device="cuda",
):
    """Long-prompt latency through the continuous engine: time to first
    token (submit to the first streamed chunk after the prompt echo) and
    completion p95, with the admission prefill on or off.

    Without the prefill, a 512-event prompt is teacher-forced through about
    512 kernel steps over about 8 segments before its first generated token;
    with it, one batched forward fills the slot's cache rows instead.
    """
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.serving import ContinuousGenerationService

    device = _device(device)
    dtype = dtype or _dtype(device)
    model = _default_transformer(
        False, dtype, embed_dim=embed_dim, num_layers=num_layers, seed=seed, device=device
    )
    service = ContinuousGenerationService(
        model, ModelType.TRANSFORMER, None, vocab_size=390,
        slots=slots, seg_steps=seg_steps, cache_len=cache_len, seed=seed,
        prefill_min=(prefill_min if prefill else 0), device=device,
    )
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(0, 390, prompt_len).astype(np.int32)
        for _ in range(requests)
    ]

    ttfts = [0.0] * requests
    totals = [0.0] * requests

    def client(index):
        begin = time.perf_counter()
        chunks = service.submit_stream(
            prompts[index], length, temperature=temperature
        )
        next(chunks)  # prompt echo: immediate
        next(chunks)  # first generated chunk
        ttfts[index] = time.perf_counter() - begin
        for _ in chunks:
            pass
        totals[index] = time.perf_counter() - begin

    def burst():
        _run_clients(client, [(index,) for index in range(requests)])

    before = launch_counts()
    try:
        burst()  # warm-up: the kernel's build and the prefill's first forward
        start = time.perf_counter()
        burst()
        elapsed = time.perf_counter() - start
    finally:
        service.close()

    ttft = np.sort(np.asarray(ttfts))
    total = np.sort(np.asarray(totals))
    return {
        "metric": "long_prompt_ttft_p95_seconds",
        "value": round(float(ttft[int(0.95 * (requests - 1))]), 4),
        "unit": "s",
        "vs_baseline": None,
        "detail": {
            "prefill": prefill,
            "prompt_len": prompt_len, "length": length,
            "requests": requests,
            "ttft_p50_s": round(float(ttft[int(0.50 * (requests - 1))]), 4),
            "ttft_p95_s": round(float(ttft[int(0.95 * (requests - 1))]), 4),
            "total_p95_s": round(float(total[int(0.95 * (requests - 1))]), 4),
            "events_per_sec": round(requests * length / elapsed, 1),
            "slots": slots, "seg_steps": seg_steps,
            **_backend(device),
            "launches": _launches_since(before),
        },
    }


def run_preprocess_benchmark(num_files: int = 240, num_workers: int = 16,
                             seed: int = 0, scaling_workers=(1, 4, 16)):
    """MIDI -> .data preprocessing throughput (BASELINE.md row 3), on the host.

    A few-hundred-file corpus of random notes, processed with 16 workers
    and full augmentation; ``scaling_workers`` adds a worker-scaling curve
    over the same corpus. The row is "preprocess + export-dataset", so the
    .data -> .tfrecord export of the produced files is timed too.
    """
    import tempfile

    from composer_tpu_torch import config as config_module
    from composer_tpu_torch.data import preprocess
    from composer_tpu_torch.data.loader import load_dataset
    from composer_tpu_torch.data.tfrecord import export_dataset
    from composer_tpu_torch.midi import Note, NoteSequence, SustainPeriod

    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp:
        raw = Path(tmp) / "raw"
        raw.mkdir()
        for index in range(num_files):
            t, notes = 0.0, []
            for _ in range(1500):  # a few minutes of music per file
                duration = float(rng.integers(80, 800))
                notes.append(
                    Note(t, t + duration, int(rng.integers(21, 109)), int(rng.integers(10, 127)))
                )
                t += float(rng.integers(20, 300))
            NoteSequence(notes, [SustainPeriod(0, t / 2)]).to_midi(
                str(raw / f"bench{index}.mid")
            )

        config = config_module.get_default()

        def convert(workers: int, out: Path) -> float:
            start = time.perf_counter()
            preprocess.convert_all(
                config, raw, out, "extend", transform=True,
                transform_percent=1.0, num_workers=workers, seed=seed,
                show_progress_bar=False,
            )
            return time.perf_counter() - start

        scaling = {}
        for workers in scaling_workers:
            if workers == num_workers:
                continue  # the headline run below covers this point
            scaling[f"files_per_sec_w{workers}"] = round(
                num_files / convert(workers, Path(tmp) / f"scale{workers}"), 2
            )

        out = Path(tmp) / "processed"
        elapsed = convert(num_workers, out)
        produced = len(preprocess.get_processed_files(out))

        dataset = load_dataset(
            preprocess.get_processed_files(out),
            batch_size=2,
            window_size=1024,
            shuffle=False,
        )
        export_start = time.perf_counter()
        export_dataset(dataset, "transformer", Path(tmp) / "bench.tfrecord")
        export_elapsed = time.perf_counter() - export_start

    files_per_sec = num_files / elapsed
    return {
        "metric": "preprocess_files_per_sec",
        "value": round(files_per_sec, 2),
        "unit": "files/sec",
        "vs_baseline": round(files_per_sec, 2),
        "detail": {
            "input_files": num_files, "output_files": produced,
            "workers": num_workers, "seconds": round(elapsed, 2),
            "host_cpus": os.cpu_count(),
            **scaling,
            "export_seconds": round(export_elapsed, 2),
            "export_files_per_sec": round(produced / export_elapsed, 1),
        },
    }


def _timed_steps(step, steps: int, device: torch.device):
    """One warm-up ``step()`` (kernel builds, allocations), then the mean
    seconds of ``steps`` more, the device synchronised before each clock
    read; returns ``(seconds a step, the last step's metrics)``."""
    metrics = step()
    _sync(device)
    float(metrics["loss"])
    start = time.perf_counter()
    for _ in range(steps):
        metrics = step()
    _sync(device)
    return (time.perf_counter() - start) / steps, metrics


def _peak_memory(device: torch.device) -> dict:
    if device.type != "cuda":
        return {}
    return {"peak_memory_gib": round(torch.cuda.max_memory_allocated(device) / 2**30, 2)}


def run_train_benchmark(
    batch_size: int = 8,
    window_size: int = 2048,
    use_relative_attention: bool = True,
    steps: int = 5,
    dtype=None,
    seed: int = 0,
    attention_chunk_size: int = 0,
    remat: bool = False,
    dropout_rate: float = 0.0,
    embed_dim: int = 256,
    num_heads: int = 16,
    num_layers: int = 8,
    use_pallas_attention: bool = False,
    device="cuda",
):
    """Training step time for the relative-attention config (BASELINE.md row 5).

    ``remat`` recomputes each block in the backward pass (the long-context
    recipe: batch 32 x 2048 with the plain attention's S x S scores);
    ``attention_chunk_size`` is taken and ignored, as everywhere in the
    port. ``embed_dim``/``num_heads``/``num_layers`` scale past the
    reference architecture (head_dim 16); ``use_pallas_attention`` trains
    through the flash kernels (their plain version on the CPU). Compute in
    ``dtype`` (bf16 on the card), parameters and Adam in float32.
    """
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
    from composer_tpu_torch.train.trainer import Trainer

    device = _device(device)
    dtype = dtype or _dtype(device)
    config = TransformerConfig(
        vocab_size=390, embed_dim=embed_dim, window_size=window_size,
        num_layers=num_layers, num_heads=num_heads,
        use_relative_attention=use_relative_attention,
        attention_dropout_rate=dropout_rate, residual_dropout_rate=dropout_rate,
        dtype=dtype, attention_chunk_size=attention_chunk_size, remat=remat,
        use_pallas_attention=use_pallas_attention,
    )
    trainer = Trainer(Transformer(config), ModelType.TRANSFORMER, 1e-3, seed=seed,
                      device=device)
    state = trainer.init_state(batch_size, window_size)

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(0, 390, (batch_size, window_size))).to(device)
    y = torch.as_tensor(rng.integers(0, 390, (batch_size, window_size))).to(device)
    generator = trainer.make_dropout_generator()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    elapsed, metrics = _timed_steps(lambda: trainer.train_step(state, x, y, generator),
                                    steps, device)

    tokens_per_sec = batch_size * window_size / elapsed
    step_tflops = _transformer_train_tflops(
        batch_size, window_size, embed_dim, num_heads, num_layers,
        relative=use_relative_attention,
    )
    return {
        "metric": "train_step_seconds",
        "value": round(elapsed, 4),
        "unit": "s/step",
        "vs_baseline": round(tokens_per_sec, 1),
        "detail": {
            "batch_size": batch_size,
            "window_size": window_size,
            "dropout_rate": dropout_rate,
            "embed_dim": embed_dim,
            "num_heads": num_heads,
            "attention": "flash" if use_pallas_attention else "plain",
            "remat": remat,
            "tokens_per_sec": round(tokens_per_sec, 1),
            "loss": round(float(metrics["loss"]), 4),
            **_roofline(step_tflops, elapsed, device),
            **_peak_memory(device),
            **_backend(device),
            "launches": _launches_since(before),
        },
    }


def run_rnn_train_benchmark(batch_size: int = 64, window_size: int = 200, steps: int = 5,
                            seed: int = 0, device="cuda"):
    """MusicRNN training step time at the default config (BASELINE.md row 3)."""
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.train.trainer import Trainer

    device = _device(device)
    trainer = Trainer(_music_rnn(seed, device), ModelType.MUSIC_RNN, 1e-3, seed=seed,
                      device=device)
    state = trainer.init_state(batch_size, window_size)
    carry = [trainer.init_rnn_carry(batch_size)]

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(0, 390, (batch_size, window_size))).to(device)
    y = torch.as_tensor(rng.integers(0, 390, (batch_size, window_size))).to(device)
    generator = trainer.make_dropout_generator()

    def step():
        metrics = trainer.train_step(state, x, y, generator, carry[0])
        carry[0] = metrics["carry"]
        return metrics

    elapsed, metrics = _timed_steps(step, steps, device)
    tokens_per_sec = batch_size * window_size / elapsed
    return {
        "metric": "rnn_train_step_seconds",
        "value": round(elapsed, 4),
        "unit": "s/step",
        "vs_baseline": round(tokens_per_sec, 1),
        "detail": {
            "batch_size": batch_size, "window_size": window_size,
            "tokens_per_sec": round(tokens_per_sec, 1),
            "loss": round(float(metrics["loss"]), 4),
            **_roofline(_rnn_train_tflops(batch_size, window_size), elapsed, device),
            **_backend(device),
        },
    }


def headline(device="cuda") -> dict:
    """The root ``bench.py``'s line: 8 x 1014 events through
    ``generate_ids(engine="auto")``, and ``detail.batch1`` at 1 x 1024 (wall
    and on-device marginal rates)."""
    result = run_decode_benchmark(length=1014, batch_size=8, device=device)
    line = {key: result[key] for key in ("metric", "value", "unit", "vs_baseline", "detail")}
    try:
        batch1 = run_decode_benchmark(length=1024, batch_size=1, device=device)
        line["detail"]["batch1"] = {
            "events_per_sec_chip": batch1["detail"]["on_device_events_per_sec_marginal"],
            "events_per_sec_wall": batch1["value"],
            "seconds": batch1["detail"]["seconds"],
            "on_device_seconds": batch1["detail"]["on_device_seconds"],
            "launches": batch1["detail"]["launches"],
        }
    except Exception as error:  # the headline line still prints, as the root bench.py's
        line["detail"]["batch1"] = {"error": str(error)[:200]}
    return line


def _rows(on_card: bool) -> list:
    """``run_all``'s rows: the JAX table's names, order and arguments. The
    rows that JAX runs only on the TPU run only on the card; elsewhere they
    return the JAX package's ``{"error": ...}`` form."""
    def card_only(fn, what):
        return fn if on_card else (lambda **_: {"error": f"{what} skipped off the card"})

    return [
        ("decode (batch 1, 1024 events, KV-cached megakernel)", run_decode_benchmark, {}),
        ("decode w/ relative attention", run_decode_benchmark,
         dict(use_relative_attention=True, length=1014)),
        ("batched decode (batch 8 x 1014, fused kernel)", run_decode_benchmark,
         dict(batch_size=8, length=1014)),
        ("batched decode (batch 8 x 1014, relative attention)", run_decode_benchmark,
         dict(batch_size=8, length=1014, use_relative_attention=True)),
        ("batched decode (batch 64 x 2048, chunked fused kernel)",
         run_batched_decode_benchmark, {}),
        ("batched decode (batch 64 x 2048, relative attention)",
         run_batched_decode_benchmark, dict(use_relative_attention=True)),
        # The unfused path at embed 1024: the route the wide kernel replaced.
        ("wide-model decode (embed 1024, batch 8, XLA scan engine)", run_decode_benchmark,
         dict(batch_size=8, length=1014, embed_dim=1024, engine="xla", repeats=2)),
        ("wide-model decode (embed 1024, batch 8, streaming wide kernel)",
         card_only(run_decode_benchmark, "wide kernel bench"),
         dict(batch_size=8, length=1014, embed_dim=1024, engine="wide", repeats=2)),
        ("wide-model decode (embed 1024, batch 8, streaming kernel, int8)",
         card_only(run_wide_int8_decode_benchmark, "int8 wide bench"), {}),
        ("wide-model decode (embed 1024, batch 8, streaming, int8 KV)",
         card_only(run_wide_int8_kv_decode_benchmark, "int8-KV wide bench"), {}),
        ("serving under Poisson arrivals (embed 1024, wide continuous)",
         card_only(run_poisson_serving_benchmark, "wide continuous bench"),
         dict(continuous=True, requests=16, mean_interarrival_ms=150.0, length=192, slots=4,
              cache_len=1024, embed_dim=1024, temperature=0.0)),
        ("serving under Poisson arrivals (embed 1024, run-to-completion)",
         card_only(run_poisson_serving_benchmark, "wide rtc bench"),
         dict(continuous=False, requests=16, mean_interarrival_ms=150.0, length=192, slots=4,
              cache_len=1024, embed_dim=1024, temperature=0.0)),
        ("long-prompt serving TTFT (prompt 512, continuous, NO prefill)",
         card_only(run_long_prompt_serving_benchmark, "long-prompt bench"),
         dict(prefill=False)),
        ("long-prompt serving TTFT (prompt 512, continuous, XLA prefill)",
         card_only(run_long_prompt_serving_benchmark, "long-prompt bench"),
         dict(prefill=True)),
        ("speculative decode (batch 1, n-gram drafts, block verify)",
         card_only(run_speculative_benchmark, "speculative bench"), {}),
        ("LSTM decode (batch 8 x 1024, stateful scan)", run_rnn_decode_benchmark, {}),
        ("serving (32 concurrent clients, coalesced batches of 8)", run_serving_benchmark, {}),
        ("serving (32 clients, relative attention)", run_serving_benchmark,
         dict(use_relative_attention=True)),
        ("serving latency, Poisson arrivals (run-to-completion)",
         card_only(run_poisson_serving_benchmark, "poisson bench"), dict(continuous=False)),
        ("serving latency, Poisson light load (continuous, mixed lengths)",
         card_only(run_poisson_serving_benchmark, "poisson bench"),
         dict(continuous=True, mean_interarrival_ms=80.0, lengths=(128, 256, 384))),
        ("serving latency, Poisson moderate load (continuous, mixed lengths)",
         card_only(run_poisson_serving_benchmark, "poisson bench"),
         dict(continuous=True, mean_interarrival_ms=40.0, lengths=(128, 256, 384))),
        ("serving latency, Poisson heavy load (continuous, mixed lengths)",
         card_only(run_poisson_serving_benchmark, "poisson bench"),
         dict(continuous=True, mean_interarrival_ms=15.0, requests=80,
              lengths=(128, 256, 384))),
        ("serving overload soak (continuous, bounded queue + deadlines)",
         card_only(run_overload_soak_benchmark, "soak bench"), {}),
        ("serving, heterogeneous sampling (32 clients, mixed temp/top-k/top-p)",
         run_serving_benchmark, dict(mixed_sampling=True)),
        ("preprocess (MIDI -> .data, full augmentation)", run_preprocess_benchmark, None),
        ("train step (relative attention, 2048 ctx)", run_train_benchmark,
         dict(batch_size=8, window_size=2048)),
        ("train step (2048 ctx, reference-default dropout 0.1)", run_train_benchmark,
         dict(batch_size=8, window_size=2048, dropout_rate=0.1)),
        ("train step (batch 32 x 2048, band attention + remat)", run_train_benchmark,
         dict(batch_size=32, window_size=2048, remat=True, steps=3)),
        ("train step (batch 32 x 2048, flash attention, no remat)",
         card_only(run_train_benchmark, "flash bench"),
         dict(batch_size=32, window_size=2048, steps=3, use_pallas_attention=True)),
        ("train step (4096 ctx, flash attention)", card_only(run_train_benchmark, "flash bench"),
         dict(batch_size=8, window_size=4096, steps=3, use_pallas_attention=True)),
        ("train step (scaled arch: embed 1024, head_dim 64, 2048 ctx)", run_train_benchmark,
         dict(batch_size=8, window_size=2048, embed_dim=1024)),
        ("train step (scaled arch, Pallas flash fwd+bwd)",
         card_only(run_train_benchmark, "flash bench"),
         dict(batch_size=8, window_size=2048, embed_dim=1024, use_pallas_attention=True)),
        ("train step (embed 2048, head_dim 128, band)", run_train_benchmark,
         dict(batch_size=4, window_size=2048, embed_dim=2048, steps=3)),
        ("train step (embed 2048, head_dim 128, Pallas flash)",
         card_only(run_train_benchmark, "flash bench"),
         dict(batch_size=4, window_size=2048, embed_dim=2048, steps=3,
              use_pallas_attention=True)),
        ("LSTM baseline train step (batch 64 x 200)", run_rnn_train_benchmark, {}),
    ]


def run_all(markdown_path=None, device="cuda"):
    """Runs every row of ``_rows``, printing each result as a JSON line and
    going on past a row that fails (its result holds ``error``); writes the
    markdown table to ``markdown_path`` when one is given, and nowhere
    else. Returns the results."""
    import datetime

    device = _device(device)
    on_card = device.type == "cuda"
    if on_card:
        # Every kernel at once, one nvcc process each, before the first row.
        from composer_tpu_torch.ops import _build

        _build.build_all(("decode_generate", "flash_attention", "spec_decode",
                          "decode_segment", "decode_wide", "decode_wide_segment"))
    results = []
    for name, fn, kwargs in _rows(on_card):
        try:
            # The host-only preprocess row takes no device.
            result = fn() if kwargs is None else fn(**kwargs, device=device)
        except Exception as error:  # record, keep going
            result = {"metric": name, "error": str(error)[:200]}
        result["workload"] = name
        results.append(result)
        print(json.dumps(result), flush=True)

    if markdown_path is not None:
        where = card_line() if on_card else "the CPU"
        lines = [
            "# Benchmarks of the PyTorch port",
            "",
            f"Measured {datetime.datetime.now():%Y-%m-%d %H:%M} on `{device.type}` ({where}) "
            "by `python -m composer_tpu_torch.bench`. Decode and serving rows carry no "
            "`vs_baseline`: the port has no target on the card yet. "
            "`on_device_seconds` and the `on_device_*_marginal` rates are read off CUDA "
            "events around each call; `launches` names the hand-written kernels each "
            "row ran. Train rows carry `tflops_per_sec`, the matmul FLOPs the step issues "
            "(full S² attention, backward = 2x forward) over the step time, and "
            "`pct_peak_bf16` against the card's published bf16 peak.",
            "",
            "| Workload | Metric | Value | vs_baseline | Detail |",
            "|---|---|---|---|---|",
        ]
        for result in results:
            if "error" in result:
                lines.append(f"| {result['workload']} | — | error | — | {result['error']} |")
                continue
            detail = ", ".join(f"{k}={v}" for k, v in result.get("detail", {}).items())
            vs = result.get("vs_baseline")
            vs_text = f"{vs}" if vs is not None else "—"
            lines.append(
                f"| {result['workload']} | {result['metric']} | "
                f"**{result['value']} {result['unit']}** | {vs_text} | {detail} |"
            )
        markdown_path = Path(markdown_path)
        markdown_path.parent.mkdir(parents=True, exist_ok=True)
        markdown_path.write_text("\n".join(lines) + "\n")
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv not in ([], ["headline"]):
        print("usage: python -m composer_tpu_torch.bench [headline]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("composer_tpu_torch.bench measures the card, and torch sees no CUDA device "
              "here; the tests run the bench's functions on the CPU", file=sys.stderr)
        return 1
    if argv == ["headline"]:
        line = headline()
        print(json.dumps(line))
        return 1 if "error" in line["detail"]["batch1"] else 0
    results = run_all(markdown_path=DEFAULT_MARKDOWN)
    failed = [result["workload"] for result in results if "error" in result]
    print(f"wrote {DEFAULT_MARKDOWN}", file=sys.stderr)
    if failed:
        print(f"{len(failed)} rows failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
