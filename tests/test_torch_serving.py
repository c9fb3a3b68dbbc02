"""The port's ``ContinuousGenerationService`` (``composer_tpu_torch/serving.py``)
on the CPU, held to the contracts of ``tests/test_serving.py`` that need no
HTTP layer, and to JAX ``generate_ids(engine="xla")`` (float32, greedy).

On the CPU (``device="cpu"``) the service runs the segment kernel's plain
version. The overload controls the JAX package tests on its
``GenerationService`` are tested here on the continuous service, which
shares the mixin. No test waits without a bound: threads are joined with a
timeout, submits that could hang carry a deadline, and a segment is held
back with an ``Event`` where the JAX tests sleep.
"""

import sys
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composer_tpu.models import ModelType as JaxModelType
from composer_tpu.models.transformer import Transformer as JaxTransformer
from composer_tpu.models.transformer import TransformerConfig as JaxConfig
from composer_tpu.train.generate import generate_ids as jax_generate_ids
from composer_tpu_torch.exceptions import (
    DeadlineExceededError,
    InvalidParameterError,
    RequestCancelledError,
    ServiceOverloadedError,
)
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.convert import params_from_flax
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.ops import decode_kernel_segmented as seg
from composer_tpu_torch.ops import decode_kernel_wide_segmented as wseg
from composer_tpu_torch.serving import ContinuousGenerationService, _service_engine
from composer_tpu_torch.train import generate as gen

VOCAB = 390
WINDOW = 64
WAIT = 60.0  # seconds: the bound on every blocking wait
_PAIR = {}


def _pair():
    """The JAX test's tiny model (1 layer, embed 16, 2 heads, window 64) in
    both packages: (jax model, jax params, port model)."""
    if not _PAIR:
        kwargs = dict(vocab_size=VOCAB, embed_dim=16, window_size=WINDOW, num_layers=1,
                      num_heads=2, attention_dropout_rate=0.0, residual_dropout_rate=0.0)
        jax_model = JaxTransformer(JaxConfig(**kwargs, dtype=jnp.float32,
                                             param_dtype=jnp.float32))
        params = jax_model.init_params(jax.random.PRNGKey(0), 1, 8)
        model = Transformer(TransformerConfig(**kwargs), device="cpu")
        model.load_state_dict(params_from_flax(jax.device_get(params), model.config))
        _PAIR["pair"] = (jax_model, params, model.eval())
    return _PAIR["pair"]


def _service(**kwargs):
    kwargs = {"slots": 2, "seg_steps": 4, "cache_len": 128, **kwargs}
    return ContinuousGenerationService(_pair()[2], ModelType.TRANSFORMER, None, VOCAB,
                                       device="cpu", **kwargs)


@pytest.fixture
def make_service():
    """Builds services that are closed when the test ends."""
    services = []

    def make(**kwargs):
        services.append(_service(**kwargs))
        return services[-1]

    yield make
    for service in services:
        service.close()


@pytest.fixture(scope="module")
def shared_service():
    service = _service(slots=3)
    yield service
    service.close()


def _xla(prompt, length):
    jax_model, params, _ = _pair()
    return np.asarray(jax_generate_ids(jax_model, JaxModelType.TRANSFORMER, params,
                                       np.asarray(prompt, np.int32), length=length,
                                       temperature=0.0, seed=0, engine="xla"))


def _start(fn, *args):
    thread = threading.Thread(target=fn, args=args, daemon=True)
    thread.start()
    return thread


def _join(threads):
    for thread in threads:
        thread.join(timeout=WAIT)
        assert not thread.is_alive(), "a submit() did not return"


class _Gate:
    """Holds the service's worker inside ``decode_segment`` from call
    ``after + 1`` on, until ``release`` is set."""

    def __init__(self, monkeypatch, after: int):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.calls = 0
        real = seg.decode_segment

        def gated(*args, **kwargs):
            self.calls += 1
            if self.calls > after:
                self.entered.set()
                assert self.release.wait(timeout=WAIT)
            return real(*args, **kwargs)

        monkeypatch.setattr(seg, "decode_segment", gated)

    def wait_entered(self):
        assert self.entered.wait(timeout=WAIT), "the worker never reached the gate"


def test_single_request_matches_xla(shared_service):
    prompt = [5, 100, 300, 17]
    out = shared_service.submit(prompt, length=6, temperature=0.0, deadline_ms=WAIT * 1e3)
    np.testing.assert_array_equal(out, _xla(prompt, 6))


def test_concurrent_mixed_lengths_match_xla(shared_service):
    """Four requests over three slots (one waits for an eviction), each with
    its own prompt length and length, all equal the XLA engine."""
    payloads = [([5, 100, 300, 17], 6), ([9], 9), ([1, 2, 3], 4), ([7, 8], 5)]
    results = [None] * len(payloads)

    def call(i):
        prompt, length = payloads[i]
        results[i] = shared_service.submit(prompt, length, temperature=0.0,
                                           deadline_ms=WAIT * 1e3)

    _join([_start(call, i) for i in range(len(payloads))])
    for (prompt, length), result in zip(payloads, results):
        np.testing.assert_array_equal(result, _xla(prompt, length))


def test_streaming_matches_blocking(shared_service):
    prompt = [5, 100, 300, 17]
    blocking = shared_service.submit(prompt, length=9, temperature=0.0, deadline_ms=WAIT * 1e3)
    chunks = list(shared_service.submit_stream(prompt, length=9, temperature=0.0,
                                               deadline_ms=WAIT * 1e3))
    assert chunks[0] == prompt
    assert len(chunks) > 2  # 9 tokens over 4-step segments: more than one chunk
    np.testing.assert_array_equal(np.asarray([t for c in chunks for t in c]), blocking)


def test_rejects_oversize_and_bad_requests(shared_service):
    for prompt, length in (([], 4), ([1, 2], 0), ([1] * (WINDOW + 1), 4), ([1, 2], 100_000),
                           ([VOCAB + 1], 4)):
        with pytest.raises(InvalidParameterError):
            shared_service.submit(prompt, length)
    with pytest.raises(InvalidParameterError):
        shared_service.submit([1, 2], 4, deadline_ms=-1)


def test_sampled_requests_run_on_the_cpu(make_service):
    """The JAX package rejects sampled requests off the TPU; the port's plain
    version samples with the kernel's Philox bits: a sampled request is
    served, and the same request on a fresh service with the same seed gives
    the same ids."""
    outputs = [make_service(seed=3).submit([5, 6, 7], 24, temperature=1.0, top_k=40,
                                           top_p=0.95, deadline_ms=WAIT * 1e3)
               for _ in range(2)]
    np.testing.assert_array_equal(outputs[0], outputs[1])
    assert outputs[0].shape == (27,) and outputs[0][3:].max() < VOCAB
    assert len(set(outputs[0][3:].tolist())) > 5


def test_close_never_strands_waiters(make_service):
    """Submits racing close() either complete or raise the shutdown error,
    and submits after close are rejected at once."""
    service = make_service()
    outcomes = [None] * 4

    def call(i):
        try:
            outcomes[i] = ("ok", service.submit([3 + i], length=[2, 3, 5, 9][i],
                                                temperature=0.0, deadline_ms=WAIT * 1e3))
        except InvalidParameterError as error:
            outcomes[i] = ("closed", str(error))

    threads = [_start(call, i) for i in range(4)]
    service.close()
    _join(threads)
    for status, value in outcomes:
        assert status in ("ok", "closed")
        if status == "closed":
            assert "closed" in value
    with pytest.raises(InvalidParameterError, match="closed"):
        service.submit([1, 2], length=2)
    with pytest.raises(InvalidParameterError, match="closed"):
        service.submit_stream([1, 2], 4, temperature=0.0)


def test_bounded_queue_rejects_when_full(make_service, monkeypatch):
    """With the one slot busy and the worker held, two submits queue and the
    other six raise ServiceOverloadedError; the gauges count them."""
    gate = _Gate(monkeypatch, after=0)
    service = make_service(slots=1, max_queue_depth=2)
    outcomes = []
    lock = threading.Lock()

    def call(i):
        try:
            service.submit([3 + i], length=2, temperature=0.0, deadline_ms=WAIT * 1e3)
            outcome = "ok"
        except ServiceOverloadedError:
            outcome = "rejected"
        with lock:
            outcomes.append(outcome)

    threads = [_start(call, 0)]
    gate.wait_entered()
    threads += [_start(call, i) for i in range(1, 9)]
    limit = time.monotonic() + WAIT
    while outcomes.count("rejected") < 6 and time.monotonic() < limit:
        time.sleep(0.01)
    gate.release.set()
    _join(threads)
    assert sorted(outcomes) == ["ok"] * 3 + ["rejected"] * 6
    stats = service.overload_stats()
    assert stats["requests_rejected"] == 6 and stats["max_queue_depth"] == 2
    assert stats["queue_depth"] == 0


def test_deadline_expires_in_queue(make_service, monkeypatch):
    """A request whose deadline passes while it waits for a slot fails with
    DeadlineExceededError from the waiting side, before the slot frees."""
    gate = _Gate(monkeypatch, after=0)
    service = make_service(slots=1)
    blocker = _start(lambda: service.submit([1], 2, temperature=0.0, deadline_ms=WAIT * 1e3))
    gate.wait_entered()
    started = time.monotonic()
    with pytest.raises(DeadlineExceededError):
        service.submit([2], length=8, temperature=0.0, deadline_ms=200)
    assert time.monotonic() - started < WAIT / 2
    gate.release.set()
    _join([blocker])
    assert service.overload_stats()["requests_expired"] == 1


def test_deadline_evicts_mid_generation(make_service, monkeypatch):
    """A deadline that expires after admission evicts the row at a segment
    boundary, and the slot serves the next request."""
    gate = _Gate(monkeypatch, after=1)
    service = make_service()
    try:
        with pytest.raises(DeadlineExceededError):
            service.submit([5, 6], length=50, temperature=0.0, deadline_ms=2000)
        assert gate.entered.is_set()  # the row ran a segment before it expired
    finally:
        gate.release.set()
    assert service.overload_stats()["requests_expired"] >= 1
    assert len(service.submit([5, 6], length=3, temperature=0.0, deadline_ms=WAIT * 1e3)) == 5


def test_cancel_before_and_during_generation(make_service, monkeypatch):
    service = make_service()
    cancel = threading.Event()
    cancel.set()  # cancelled before the worker sees it
    with pytest.raises(RequestCancelledError):
        service.submit([1], length=2, cancel=cancel, deadline_ms=WAIT * 1e3)
    assert service.overload_stats()["requests_cancelled"] == 1

    gate = _Gate(monkeypatch, after=1)
    cancel = threading.Event()
    errors = []

    def call():
        try:
            service.submit([5, 6], length=50, temperature=0.0, cancel=cancel,
                           deadline_ms=WAIT * 1e3)
        except RequestCancelledError as error:
            errors.append(error)

    thread = _start(call)
    gate.wait_entered()
    cancel.set()
    gate.release.set()
    _join([thread])
    assert len(errors) == 1
    assert service.overload_stats()["requests_cancelled"] == 2


def test_admission_prefill_matches_unprefilled(make_service):
    """A long prompt admitted with the prefill forward (row clock started
    mid-prompt) returns exactly the tokens of teacher forcing step by step,
    and a second request through the same state still matches."""
    prompt = list(np.random.default_rng(8).integers(0, VOCAB, 17))
    outputs = {}
    for prefill_min in (0, 4):
        service = make_service(prefill_min=prefill_min)
        outputs[prefill_min] = [service.submit(p, n, temperature=0.0, deadline_ms=WAIT * 1e3)
                                for p, n in ((prompt, 6), (prompt[:9], 5))]
    for forced, prefilled in zip(outputs[0], outputs[4]):
        np.testing.assert_array_equal(forced, prefilled)
    np.testing.assert_array_equal(outputs[0][0], _xla(prompt, 6))


def test_prefix_cache_hit_matches_cold_admission(make_service):
    rng = np.random.default_rng(11)
    long_prompt = list(rng.integers(0, VOCAB, 17))
    other_prompt = list(rng.integers(0, VOCAB, 17))
    outputs, stats = {}, {}
    for cache_mb in (0.0, 8.0):
        service = make_service(prefill_min=4, prefix_cache_mb=cache_mb)
        outputs[cache_mb] = [service.submit(p, n, temperature=0.0, deadline_ms=WAIT * 1e3)
                             for p, n in ((long_prompt, 6), (long_prompt, 6),
                                          (other_prompt, 5))]
        stats[cache_mb] = service.overload_stats()
    for cold, cached in zip(outputs[0.0], outputs[8.0]):
        np.testing.assert_array_equal(cold, cached)
    assert stats[0.0]["prefix_cache_hits"] == 0 and stats[0.0]["prefix_cache_entries"] == 0
    assert stats[8.0]["prefix_cache_hits"] == 1
    assert stats[8.0]["prefix_cache_misses"] == 2
    assert stats[8.0]["prefix_cache_entries"] == 2 and stats[8.0]["prefix_cache_bytes"] > 0


def test_prefix_cache_lru_eviction_respects_budget(make_service):
    prompts = [list(np.random.default_rng(12 + i).integers(0, VOCAB, 17)) for i in range(3)]
    service = make_service(prefill_min=4, prefix_cache_mb=8.0)
    service.submit(prompts[0], 4, temperature=0.0, deadline_ms=WAIT * 1e3)
    one_entry = service.overload_stats()["prefix_cache_bytes"]
    assert one_entry > 0
    # A budget for exactly one entry: each new prefix evicts the older one.
    service = make_service(prefill_min=4, prefix_cache_mb=(one_entry + 1) / (1024 * 1024))
    for prompt in prompts:
        service.submit(prompt, 4, temperature=0.0, deadline_ms=WAIT * 1e3)
    stats = service.overload_stats()
    assert stats["prefix_cache_entries"] == 1 and stats["prefix_cache_misses"] == 3
    assert stats["prefix_cache_bytes"] <= one_entry + 1
    service.submit(prompts[-1], 4, temperature=0.0, deadline_ms=WAIT * 1e3)
    assert service.overload_stats()["prefix_cache_hits"] == 1
    service.close()
    assert service.overload_stats()["prefix_cache_entries"] == 0  # close releases them


def test_many_submitters_keep_the_gauges_consistent(make_service):
    """16 threads (more than this machine's cores) submit at once with the
    interpreter switching threads every 10 us: every request completes or is
    rejected, none is lost, and the gauges add up."""
    service = make_service(max_queue_depth=6)
    outcomes = []
    lock = threading.Lock()

    def call(i):
        try:
            service.submit([1 + i % 7, 2 + i], 3 + i % 5, temperature=0.0,
                           deadline_ms=WAIT * 1e3)
            outcome = "ok"
        except ServiceOverloadedError:
            outcome = "rejected"
        with lock:
            outcomes.append(outcome)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _join([_start(call, i) for i in range(16)])
    finally:
        sys.setswitchinterval(interval)
    stats = service.overload_stats()
    assert len(outcomes) == 16 and outcomes.count("ok") >= 6
    assert service.requests_completed == outcomes.count("ok")
    assert stats["requests_rejected"] == outcomes.count("rejected")
    assert stats["queue_depth"] == 0


def test_surface_and_gauges(shared_service):
    """``max_batch_size`` is the slot count, batch sizes are recorded per
    segment, and the speculative fields report zeros."""
    before = shared_service.requests_completed
    shared_service.submit([4, 4], 5, temperature=0.0, deadline_ms=WAIT * 1e3)
    stats = shared_service.overload_stats()
    assert shared_service.max_batch_size == 3 and max(shared_service.batch_sizes) <= 3
    assert shared_service.requests_completed == before + 1
    assert stats["spec_requests"] == 0 and stats["spec_acceptance_last"] is None
    assert stats["latency_p50_s"] > 0 and stats["latency_p95_s"] >= stats["latency_p50_s"]


def test_engines_and_devices():
    """The wide engine takes at most the kernel's 8 slots; an unknown engine
    is refused; the default device is the card, which raises on a torch
    without CUDA; a capacity below two live buckets is refused."""
    model = _pair()[2]
    with pytest.raises(InvalidParameterError, match="fewer slots"):
        ContinuousGenerationService(model, ModelType.TRANSFORMER, None, VOCAB, engine="wide",
                                    slots=wseg.MAX_BATCH + 1, device="cpu")
    with pytest.raises(InvalidParameterError):
        ContinuousGenerationService(model, ModelType.TRANSFORMER, None, VOCAB, engine="spec")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousGenerationService(model, ModelType.TRANSFORMER, None, VOCAB)
    wide = Transformer(TransformerConfig(vocab_size=VOCAB, embed_dim=1024, num_heads=128,
                                         num_layers=1, window_size=1024), device="cpu")
    with pytest.raises(InvalidParameterError, match="shared memory"):
        ContinuousGenerationService(wide, ModelType.TRANSFORMER, None, VOCAB, device="cpu")


def test_wide_engine_serves_and_matches_resident(make_service):
    """``engine="wide"`` serves through the streamed-weight segment kernel's
    plain version: concurrent greedy requests equal the resident engine's
    and JAX's unfused path."""
    prompts = [[5, 8, 11], [250, 3], [7, 7, 7, 7]]
    results = {}
    for engine in ("resident", "wide"):
        service = make_service(engine=engine)
        assert service.wide == (engine == "wide")
        outs = [None] * len(prompts)

        def call(i):
            outs[i] = service.submit(prompts[i], length=6, temperature=0.0,
                                     deadline_ms=WAIT * 1e3)

        _join([_start(call, i) for i in range(len(prompts))])
        results[engine] = outs
    assert isinstance(service._state[0], torch.Tensor) and service._state[0].dim() == 5
    for wide, resident, prompt in zip(results["wide"], results["resident"], prompts):
        np.testing.assert_array_equal(wide, resident)
        np.testing.assert_array_equal(wide, _xla([prompt], 6)[0])


def test_wide_engine_streams_and_reports_health(make_service):
    """The wide engine streams, and reports the admission prefill and the
    prefix cache off: both write the resident layout, as in the JAX
    package."""
    service = make_service(engine="wide", prefill_min=2)
    flat = [t for chunk in service.submit_stream([5, 8], length=5, temperature=0.0,
                                                 deadline_ms=WAIT * 1e3) for t in chunk]
    assert flat[:2] == [5, 8] and len(flat) == 7
    np.testing.assert_array_equal(flat, _xla([[5, 8]], 5)[0])
    assert service.overload_stats()["prefix_cache_entries"] == 0
    assert service.prefill_min == 0 and service.prefix_cache_bytes == 0


def test_wide_engine_packs_int8_weights(make_service, monkeypatch):
    """``COMPOSER_WIDE_INT8=1`` packs int8 weights for the wide engine, as in
    the JAX package, and its greedy ids equal ``generate_ids(engine="wide")``
    under the same flag."""
    monkeypatch.setenv("COMPOSER_WIDE_INT8", "1")
    service = make_service(engine="wide")
    assert service.packed["big_w"].dtype == torch.int8 and "wscale" in service.packed
    prompt = [5, 100, 300, 17]
    out = service.submit(prompt, length=8, temperature=0.0, deadline_ms=WAIT * 1e3)
    expected = gen.generate_ids(_pair()[2], ModelType.TRANSFORMER, None, [prompt], length=8,
                                temperature=0.0, cache_len=128, engine="wide")
    np.testing.assert_array_equal(out, expected[0])


def test_auto_engine_follows_generate_ids():
    """``auto`` takes the wide engine exactly where ``generate_ids`` would: on
    a CUDA device for a model whose packed weights outgrow the L2 (the
    embed-1024 flagship, checked on its config without building it), never
    on the CPU nor for a small model."""
    small = _pair()[2]
    flagship = SimpleNamespace(config=TransformerConfig(
        vocab_size=VOCAB, embed_dim=1024, window_size=2048, num_layers=8, num_heads=16,
        use_relative_attention=True))
    default = SimpleNamespace(config=TransformerConfig(vocab_size=VOCAB))
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert gen._packed_weight_bytes(flagship.config) > gen.HOPPER_L2_BYTES
    for model, device, engine in ((flagship, card, "wide"), (default, card, "resident"),
                                  (small, card, "resident"), (flagship, cpu, "resident")):
        assert _service_engine(model, "auto", 2048, device) == engine
        assert gen._use_wide_kernel(model, ModelType.TRANSFORMER, 2048, "auto",
                                    device) == (engine == "wide")
    for explicit in ("resident", "wide"):
        assert _service_engine(flagship, explicit, 2048, card) == explicit
    service = _service(engine="auto")
    try:
        assert not service.wide
    finally:
        service.close()
