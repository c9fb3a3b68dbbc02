"""The port's HTTP serving layer (``composer_tpu_torch/serving.py``:
``GenerationService``, ``_prompt_from_json``, ``_midi_base64_from_ids``,
``build_server``) on the CPU, held to the contracts of
``tests/test_serving.py`` and to the JAX package's server on the same
weights (float32: identical greedy ``events``, byte-identical MIDI).

On the CPU (``device="cpu"``) ``generate_ids(engine="auto")`` takes the
unfused path, as the JAX package's does there. No wait is unbounded: every
``urlopen`` has a timeout, threads are daemons joined with a timeout, servers
bind port 0 and are shut down in a ``finally`` or a fixture's teardown, and
where the JAX tests rely on a coalescing window's timing the worker is held
inside ``generate_ids`` with an ``Event`` instead.
"""

import base64
import contextlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composer_tpu.serving as jax_serving
import composer_tpu.train.generate as jax_gen
from composer_tpu.config import get_default as jax_get_default
from composer_tpu.midi import events as jax_events
from composer_tpu.models import ModelType as JaxModelType
from composer_tpu.models.transformer import Transformer as JaxTransformer
from composer_tpu.models.transformer import TransformerConfig as JaxConfig
from composer_tpu_torch.config import get_default
from composer_tpu_torch.exceptions import (
    DeadlineExceededError,
    InvalidParameterError,
    RequestCancelledError,
    ServiceOverloadedError,
)
from composer_tpu_torch.midi import events, midi_io
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.convert import params_from_flax
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.serving import (
    ContinuousGenerationService,
    GenerationService,
    _midi_base64_from_ids,
    _Request,
    _prompt_from_json,
    build_server,
)
from composer_tpu_torch.train import generate as gen

VOCAB = 390  # the default codec's vocabulary, so MIDI prompts encode in range
WINDOW = 64
WAIT = 60.0  # seconds: the bound on every blocking wait
_PAIR = {}


def _pair():
    """The JAX test's tiny model (1 layer, embed 16, 2 heads, window 64) in
    both packages, float32: (jax model, jax params, port model)."""
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
    kwargs = {"max_batch_size": 4, "max_wait_ms": 300.0, **kwargs}
    return GenerationService(_pair()[2], ModelType.TRANSFORMER, None, VOCAB, device="cpu",
                             **kwargs)


@contextlib.contextmanager
def _serving(service, config=None, default_length=12):
    """``build_server`` on port 0 in a daemon thread; shut down and closed
    on exit, the service with it."""
    http_server = build_server(service, config or get_default(), port=0,
                               default_length=default_length)
    thread = threading.Thread(target=http_server.serve_forever, daemon=True)
    thread.start()
    try:
        yield http_server
    finally:
        http_server.shutdown()
        http_server.server_close()
        service.close()
        thread.join(timeout=WAIT)


@pytest.fixture(scope="module")
def server():
    service = _service()
    with _serving(service) as http_server:
        yield http_server, service


@pytest.fixture(scope="module")
def jax_server():
    jax_model, params, _ = _pair()
    service = jax_serving.GenerationService(jax_model, JaxModelType.TRANSFORMER, params, VOCAB,
                                            max_batch_size=4, max_wait_ms=300.0)
    http_server = jax_serving.build_server(service, jax_get_default(), port=0,
                                           default_length=12)
    thread = threading.Thread(target=http_server.serve_forever, daemon=True)
    thread.start()
    yield http_server, service
    http_server.shutdown()
    http_server.server_close()
    service.close()
    thread.join(timeout=WAIT)


def _url(http_server, path):
    return f"http://127.0.0.1:{http_server.server_port}{path}"


def _post(http_server, payload, path="/v1/generate"):
    request = urllib.request.Request(_url(http_server, path), data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=WAIT) as response:
        return response.status, json.loads(response.read())


def _health(http_server):
    with urllib.request.urlopen(_url(http_server, "/v1/health"), timeout=WAIT) as response:
        return json.loads(response.read())


def _start(fn, *args):
    thread = threading.Thread(target=fn, args=args, daemon=True)
    thread.start()
    return thread


def _join(threads):
    for thread in threads:
        thread.join(timeout=WAIT)
        assert not thread.is_alive(), "a request did not return"


class _Gate:
    """Holds the worker inside ``module.generate_ids`` from call ``after + 1``
    on, until ``release`` is set (``module``: either package's
    ``train/generate.py``; both services look the function up per batch)."""

    def __init__(self, monkeypatch, module=gen, after: int = 0):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.calls = 0
        real = module.generate_ids

        def gated(*args, **kwargs):
            self.calls += 1
            if self.calls > after:
                self.entered.set()
                assert self.release.wait(timeout=WAIT)
            return real(*args, **kwargs)

        monkeypatch.setattr(module, "generate_ids", gated)

    def wait_entered(self):
        assert self.entered.wait(timeout=WAIT), "the worker never reached the gate"


def _queued(service, count):
    """Waits (bounded) until exactly ``count`` requests sit in the queue."""
    limit = time.monotonic() + WAIT
    while service.overload_stats()["queue_depth"] != count:
        assert time.monotonic() < limit, "the queue never held the requests"
        time.sleep(0.01)


def _burst(http_server, service, payloads, monkeypatch, module=gen):
    """Posts ``payloads`` from one thread each while the worker is held on a
    blocker request of another signature, so that all of them are queued
    when it forms the next batch (``module``: the ``train/generate.py`` of
    ``service``'s package). Returns the responses and the burst's batch
    sizes."""
    gate = _Gate(monkeypatch, module)
    before = len(service.batch_sizes)
    blocker = _start(_post, http_server, {"events": [9], "length": 1, "temperature": 0.0})
    gate.wait_entered()
    results = [None] * len(payloads)

    def call(i):
        results[i] = _post(http_server, payloads[i])

    threads = [_start(call, i) for i in range(len(payloads))]
    try:
        _queued(service, len(payloads))
    finally:
        gate.release.set()
    _join([blocker] + threads)
    assert all(status == 200 for status, _ in results), results
    return [body for _, body in results], service.batch_sizes[before + 1:]


def _midi_bytes(module, notes, tmp_path, name="prompt.mid"):
    path = tmp_path / name
    module.NoteSequence([module.Note(*n) for n in notes]).to_midi(str(path))
    return path.read_bytes()


NOTES = [(i * 200.0, i * 200.0 + 150.0, 60 + i, 80) for i in range(4)]


# ----------------------------------------------------------- the contracts
def test_health(server):
    body = _health(server[0])
    assert body["status"] == "ok"
    assert body["model_type"] == "transformer"
    assert body["vocab_size"] == VOCAB
    assert body["backend"] == "cpu" and body["max_batch_size"] == 4


def test_generate_from_event_ids(server):
    status, body = _post(server[0], {"events": [1, 2, 3], "length": 5, "temperature": 0.8})
    assert status == 200
    events = body["events"]
    assert events[:3] == [1, 2, 3] and len(events) == 8
    assert all(0 <= e < VOCAB for e in events)
    assert "midi_base64" not in body


def test_generate_from_midi_prompt_returns_midi(server, tmp_path):
    midi_b64 = base64.b64encode(_midi_bytes(events, NOTES, tmp_path)).decode()
    status, body = _post(server[0], {"midi_base64": midi_b64, "length": 4, "prompt_length": 6})
    assert status == 200
    assert len(body["events"]) == 10  # 6 prompt + 4 generated
    parsed = midi_io.parse_midi(base64.b64decode(body["midi_base64"]))
    assert sum(len(i.notes) for i in parsed.instruments) >= 1


def test_concurrent_requests_are_batched(server, monkeypatch):
    http_server, service = server
    bodies, sizes = _burst(http_server, service, [{"events": [5, 6], "length": 3}] * 3,
                           monkeypatch)
    assert sum(sizes) == 3 and max(sizes) >= 2, sizes  # coalesced, not 3 decodes
    assert all(b["events"][:2] == [5, 6] and len(b["events"]) == 5 for b in bodies)


BAD_BODIES = [
    {},  # no prompt
    {"events": [1], "midi_base64": "AAAA"},  # both prompts
    {"events": ["x"]},  # non-integer ids
    {"events": [VOCAB + 5]},  # out of vocabulary
    {"events": [1], "length": 0},  # bad length
    {"midi_base64": "!!!not-base64!!!"},
    {"midi_base64": base64.b64encode(b"junkjunkjunk").decode()},
]


def test_bad_requests_are_400(server):
    for payload in BAD_BODIES:
        with pytest.raises(urllib.error.HTTPError) as info:
            _post(server[0], payload)
        assert info.value.code == 400, payload
        assert "error" in json.loads(info.value.read())
    with pytest.raises(urllib.error.HTTPError) as info:
        _post(server[0], {"events": [1]}, path="/v1/nope")
    assert info.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(_url(server[0], "/v1/nope"), timeout=WAIT)
    assert info.value.code == 404


def test_incompatible_signatures_both_complete(server):
    results = [None] * 2

    def call(i, length):
        results[i] = _post(server[0], {"events": [7, 8, 9], "length": length})

    _join([_start(call, 0, 2), _start(call, 1, 4)])
    assert results[0][0] == 200 and len(results[0][1]["events"]) == 5
    assert results[1][0] == 200 and len(results[1][1]["events"]) == 7


def test_mixed_sampling_settings_coalesce(server, monkeypatch):
    """Requests differing only in sampling settings (and in length within
    one bucket) share a batch, and the greedy row equals a lone greedy
    request's response."""
    http_server, service = server
    baseline = _post(http_server, {"events": [5, 6], "length": 4, "temperature": 0.0})[1]
    bodies, sizes = _burst(http_server, service, [
        {"events": [5, 6], "length": 4, "temperature": 0.0},
        {"events": [5, 6], "length": 4, "temperature": 1.3, "top_k": 7},
        {"events": [5, 6], "length": 3, "temperature": 0.8, "top_p": 0.9},
    ], monkeypatch)
    assert sum(sizes) == 3 and max(sizes) >= 2, sizes
    assert bodies[0]["events"] == baseline["events"]
    assert len(bodies[2]["events"]) == 5  # its own length, though the bucket decoded 4


def test_mixed_prompt_lengths_coalesce(server, monkeypatch):
    """Prompts of different lengths in one bucket share a batch (ragged
    rows), and greedy rows equal their lone responses."""
    http_server, service = server
    base_a = _post(http_server, {"events": [5, 6, 7], "length": 4, "temperature": 0.0})[1]
    base_b = _post(http_server, {"events": [9, 4, 2], "length": 4, "temperature": 0.0})[1]
    bodies, sizes = _burst(http_server, service, [
        {"events": [5, 6, 7], "length": 4, "temperature": 0.0},
        {"events": [9, 4, 2], "length": 4, "temperature": 0.0},
        {"events": [1, 2, 3, 4], "length": 4, "temperature": 0.0},
    ], monkeypatch)
    assert max(sizes) >= 2, sizes
    assert bodies[0]["events"] == base_a["events"]
    assert bodies[1]["events"] == base_b["events"]
    assert bodies[2]["events"][:4] == [1, 2, 3, 4] and len(bodies[2]["events"]) == 8


def test_streaming_on_run_to_completion_engine(server):
    request = urllib.request.Request(
        _url(server[0], "/v1/generate"),
        data=json.dumps({"events": [5, 6], "length": 3, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=WAIT) as response:
        assert response.headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(raw) for raw in response]
    assert lines[-1] == {"done": True}
    assert len(lines) == 2  # one chunk: the whole generation
    events = [t for line in lines[:-1] for t in line["events"]]
    assert events[:2] == [5, 6] and len(events) == 5


@pytest.fixture(scope="module")
def continuous_server():
    service = ContinuousGenerationService(_pair()[2], ModelType.TRANSFORMER, None, VOCAB,
                                          slots=3, seg_steps=4, cache_len=128, device="cpu")
    with _serving(service, default_length=4) as http_server:
        yield http_server, service


def test_continuous_behind_http(continuous_server):
    http_server, service = continuous_server
    body = _health(http_server)
    assert body["status"] == "ok" and body["backend"] == "cpu"
    assert body["max_batch_size"] == service.slots
    assert "prefix_cache_hits" in body
    status, body = _post(http_server, {"events": [5, 6], "length": 3, "temperature": 0.0})
    assert status == 200 and body["events"][:2] == [5, 6] and len(body["events"]) == 5
    assert body["events"] == gen.generate_ids(_pair()[2], ModelType.TRANSFORMER, None, [5, 6],
                                              length=3, temperature=0.0).tolist()


def test_streaming_over_http(continuous_server):
    """ndjson lines arrive per segment and concatenate to the blocking
    response; parameter errors are a clean 400 before any header."""
    http_server, _ = continuous_server
    request = urllib.request.Request(
        _url(http_server, "/v1/generate"),
        data=json.dumps({"events": [5, 6, 7], "length": 9, "temperature": 0.0,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=WAIT) as response:
        assert response.status == 200
        assert response.headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(raw) for raw in response]
    assert lines[-1] == {"done": True} and len(lines) > 3
    streamed = [t for line in lines[:-1] for t in line["events"]]
    status, body = _post(http_server, {"events": [5, 6, 7], "length": 9, "temperature": 0.0})
    assert status == 200 and body["events"] == streamed
    for bad in ({"events": [], "stream": True},
                {"events": [5], "stream": True, "return_midi": True}):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(http_server, bad)
        assert err.value.code == 400


def test_close_never_strands_waiters():
    """Submits racing close() either complete or raise the shutdown error,
    and submits after close are rejected at once."""
    service = _service(max_wait_ms=200.0)
    outcomes = [None] * 4

    def call(i):
        try:
            # Lengths 2/3/5/9 bucket to 2/4/8/16: no two coalesce.
            outcomes[i] = ("ok", service.submit([3 + i], length=[2, 3, 5, 9][i],
                                                deadline_ms=WAIT * 1e3))
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


def test_bounded_queue_rejects_when_full(monkeypatch):
    """With the worker held on a first request, two submits queue and the
    other six raise ServiceOverloadedError; the gauges count them."""
    gate = _Gate(monkeypatch)
    service = _service(max_batch_size=1, max_wait_ms=0.0, max_queue_depth=2)
    outcomes = []
    lock = threading.Lock()

    def call(i):
        try:
            service.submit([3 + i], length=2, deadline_ms=WAIT * 1e3)
            outcome = "ok"
        except ServiceOverloadedError:
            outcome = "rejected"
        with lock:
            outcomes.append(outcome)

    try:
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
    finally:
        gate.release.set()
        service.close()
    assert service.overload_stats()["queue_depth"] == 0


def test_deadline_expires_in_queue(monkeypatch):
    """A request whose deadline passes while the worker is busy fails with
    DeadlineExceededError from the waiting side, before the worker frees."""
    gate = _Gate(monkeypatch)
    service = _service(max_batch_size=2, max_wait_ms=0.0)
    try:
        blocker = _start(lambda: service.submit([1], length=2, deadline_ms=WAIT * 1e3))
        gate.wait_entered()
        started = time.monotonic()
        with pytest.raises(DeadlineExceededError):
            service.submit([2], length=60, deadline_ms=200)
        assert time.monotonic() - started < WAIT / 2
        gate.release.set()
        _join([blocker])
        assert service.overload_stats()["requests_expired"] == 1
    finally:
        gate.release.set()
        service.close()


def test_cancel_drops_request_before_dispatch():
    service = _service(max_batch_size=1, max_wait_ms=0.0)
    try:
        cancel = threading.Event()
        cancel.set()  # cancelled before the worker sees it
        with pytest.raises(RequestCancelledError):
            service.submit([1], length=2, cancel=cancel, deadline_ms=WAIT * 1e3)
        assert service.overload_stats()["requests_cancelled"] == 1
        assert service.batch_sizes == []
    finally:
        service.close()


def test_http_overload_status_codes(monkeypatch):
    """Deadline -> 503, queue full -> 429 (the expired request holds the one
    place until the worker drops it), a failed generation -> 500, and
    /v1/health carries the overload gauges."""
    gate = _Gate(monkeypatch)
    service = _service(max_batch_size=1, max_wait_ms=0.0, max_queue_depth=1)
    with _serving(service) as http_server:
        hold = _start(_post, http_server, {"events": [9], "length": 2})
        try:
            gate.wait_entered()
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(http_server, {"events": [8], "length": 2, "deadline_ms": 100})
            assert err.value.code == 503
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(http_server, {"events": [6], "length": 2})
            assert err.value.code == 429
            assert "queue is full" in json.loads(err.value.read())["error"]
        finally:
            gate.release.set()
        _join([hold])
        _queued(service, 0)
        body = _health(http_server)
        assert body["requests_expired"] == 1 and body["requests_rejected"] == 1
        assert body["latency_p95_s"] > 0 and body["requests_served"] == 1

        def fail(*args, **kwargs):
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(gen, "generate_ids", fail)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(http_server, {"events": [5], "length": 2})
        assert err.value.code == 500
        assert "kernel launch failed" in json.loads(err.value.read())["error"]


def test_health_reports_spec_acceptance(monkeypatch):
    """A batch the speculative engine served shows in /v1/health's gauges.
    Off the card ``auto`` skips that engine, so its gate is forced here and
    the speculative kernel's plain version runs under the service."""
    monkeypatch.setattr(gen, "_use_spec_kernel",
                        lambda m, mt, batch, cache_len, engine, device, temps=None: (
                            batch == 1 and temps is not None
                            and bool(np.all(np.asarray(temps) <= 0))))
    spec_runs = []
    real_spec = gen._spec_generate
    monkeypatch.setattr(gen, "_spec_generate",
                        lambda *a, **k: spec_runs.append(1) or real_spec(*a, **k))
    with _serving(_service(max_wait_ms=5.0)) as http_server:
        baseline = _health(http_server)
        assert baseline["spec_requests"] == 0 and baseline["spec_acceptance_last"] is None
        _, body = _post(http_server, {"events": [5, 8, 11], "length": 4, "temperature": 0.0})
        assert len(body["events"]) == 7 and spec_runs == [1]
        stats = _health(http_server)
        assert stats["spec_requests"] == 1
        assert stats["spec_acceptance_last"] >= 1.0 and stats["spec_acceptance_mean"] >= 1.0
        # The service divides the bucket's length by the generation blocks.
        assert stats["spec_acceptance_last"] == round(4 / int(gen.LAST_SPEC_STATS[1]), 3)
        # A sampled request stays off the speculative engine.
        _post(http_server, {"events": [5, 8, 11], "length": 4, "temperature": 0.9})
        assert _health(http_server)["spec_requests"] == 1 and spec_runs == [1]


def test_batches_are_not_padded_to_max_batch_size(monkeypatch):
    """A lone request dispatches one row: the port has no ``wide_batch_pad``
    (a CUDA kernel has no per-shape compile to amortize), and the argument
    is refused."""
    shapes = []
    real = gen.generate_ids

    def spy(model, model_type, params, prompts, **kwargs):
        shapes.append(np.asarray(prompts).shape[0])
        return real(model, model_type, params, prompts, **kwargs)

    monkeypatch.setattr(gen, "generate_ids", spy)
    service = _service(max_wait_ms=5.0)
    try:
        out = service.submit([5, 8, 11], length=4, temperature=0.0, deadline_ms=WAIT * 1e3)
        assert len(out) == 7
    finally:
        service.close()
    assert shapes == [1]
    with pytest.raises(TypeError):
        _service(wide_batch_pad=True)


def test_card_refuses_a_cache_no_kernel_admits():
    """On the card a request whose padded cache (prompt and length, each
    rounded up to a power of two) no decode kernel admits is refused with
    400 before it is queued, instead of running the unfused path; on the
    CPU the same request is served."""
    from composer_tpu_torch.serving import _kernel_admits

    model = _pair()[2]
    assert _kernel_admits(model, ModelType.TRANSFORMER, 4 + 4, False)
    assert not _kernel_admits(model, ModelType.TRANSFORMER, 4 + 65536, False)
    # The wide kernel's shared memory does not grow with the cache.
    assert _kernel_admits(model, ModelType.TRANSFORMER, 4 + 65536, True)
    service = _service(max_wait_ms=5.0)
    # The check reads only the device's type, on the submitting thread.
    service.device = torch.device("cuda")
    with _serving(service) as http_server:
        with pytest.raises(InvalidParameterError, match="No decode kernel admits"):
            service.submit([5, 8, 11], length=40000, temperature=0.0)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(http_server, {"events": [5, 8, 11], "length": 40000})
        assert err.value.code == 400
        assert "No decode kernel admits" in json.loads(err.value.read())["error"]
        assert service.requests_completed == 0 and service._pending == 0


def test_batches_pad_with_the_last_request(monkeypatch):
    """Three rows pad to a batch of four: the padding row replicates the
    last request (prompt and sampling settings), as in the JAX package, and
    each response is its own prompt and its own length."""
    seen = []
    real = gen.generate_ids

    def spy(model, model_type, params, prompts, **kwargs):
        seen.append((np.asarray(prompts).copy(), kwargs))
        return real(model, model_type, params, prompts, **kwargs)

    monkeypatch.setattr(gen, "generate_ids", spy)
    service = _service()
    try:
        requests = [_Request(np.asarray(p, np.int32), n, t, k, q) for p, n, t, k, q in (
            ([1, 2, 3], 4, 0.0, 0, 0.0), ([4], 4, 0.7, 5, 0.0), ([6, 7], 3, 1.0, 0, 0.9))]
        service._harvest(service._dispatch(requests))
    finally:
        service.close()
    prompts, kwargs = seen[0]
    assert prompts.shape == (4, 4)
    np.testing.assert_array_equal(prompts[3], prompts[2])
    np.testing.assert_array_equal(prompts[:, 0], [1, 4, 6, 6])
    np.testing.assert_array_equal(kwargs["prompt_lengths"], [3, 1, 2, 2])
    np.testing.assert_allclose(kwargs["temperature"], [0.0, 0.7, 1.0, 1.0])
    np.testing.assert_array_equal(kwargs["top_k"], [0, 5, 0, 0])
    np.testing.assert_allclose(kwargs["top_p"], [0.0, 0.0, 0.9, 0.9])
    assert kwargs["length"] == 4 and kwargs["engine"] == "auto"
    assert [r.result.tolist()[:len(r.prompt_ids)] for r in requests] == [[1, 2, 3], [4], [6, 7]]
    assert [len(r.result) for r in requests] == [7, 5, 5]
    assert service.batch_sizes == [3] and service.requests_completed == 3


def test_server_admits_a_burst_of_connections():
    """32 clients connect at once while the server has not yet accepted
    any: all get through the listen backlog (socketserver's backlog of 5,
    the JAX server's, leaves the rest to retry a second later)."""
    service = _service()
    http_server = build_server(service, get_default(), port=0)
    connections = []
    try:
        for _ in range(32):
            connections.append(socket.create_connection(("127.0.0.1", http_server.server_port),
                                                        timeout=5))
    finally:
        for connection in connections:
            connection.close()
        http_server.server_close()
        service.close()
    assert len(connections) == 32


def test_service_devices_and_refusals():
    """The card by default, raising where torch has no CUDA; a mesh whose
    model degree does not divide the heads is refused (the JAX package falls
    back to its band path there; ROADMAP Queue 3). No ranks are started."""
    from composer_tpu_torch.parallel import Mesh

    model = _pair()[2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GenerationService(model, ModelType.TRANSFORMER, None, VOCAB)
    mesh = Mesh(data=1, model=3, rank=0, data_index=0, model_index=0, ranks=(0, 1, 2),
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="heads 2 not divisible by model=3"):
        GenerationService(model, ModelType.TRANSFORMER, None, VOCAB, mesh=mesh,
                          device="cpu")


# ----------------------------------------------------- against the JAX server
def _midi_body(tmp_path):
    return {"midi_base64": base64.b64encode(_midi_bytes(events, NOTES, tmp_path)).decode(),
            "length": 5, "prompt_length": 6, "temperature": 0.0}


@pytest.mark.parametrize("body", [
    {"events": [1, 2, 3], "length": 5, "temperature": 0.0},
    {"events": [5, 100, 300, 17, 42], "length": 13, "temperature": 0.0},
    {"events": [250], "temperature": 0.0},  # the server's default length
    "midi",
], ids=["events", "events-long", "default-length", "midi"])
def test_greedy_events_match_the_jax_server(server, jax_server, body, tmp_path):
    body = _midi_body(tmp_path) if body == "midi" else body
    ours, theirs = _post(server[0], body)[1], _post(jax_server[0], body)[1]
    assert ours["events"] == theirs["events"]
    assert ours.get("midi_base64") == theirs.get("midi_base64")


def test_ragged_batch_matches_the_jax_server(server, jax_server, monkeypatch):
    """Ragged prompts coalesced into one batch on both servers give the JAX
    server's greedy events, MIDI renderings included."""
    payloads = [{"events": [5, 6, 7, 8, 9], "length": 6, "temperature": 0.0},
                {"events": [9, 4, 2, 11, 300, 17], "length": 5, "temperature": 0.0,
                 "return_midi": True},
                {"events": [1, 2, 3, 4, 5, 6, 7, 8], "length": 7, "temperature": 0.0}]
    ours, sizes = _burst(*server, payloads, monkeypatch)
    theirs, jax_sizes = _burst(*jax_server, payloads, monkeypatch, module=jax_gen)
    assert sizes == jax_sizes == [3], (sizes, jax_sizes)
    assert "midi_base64" in ours[1]
    for mine, reference in zip(ours, theirs):
        assert mine == reference


def test_sampled_responses_hold_shape_and_vocabulary(server, jax_server):
    """Sampled streams differ between the packages (Philox against
    threefry), so they are held by shape and vocabulary."""
    body = {"events": [3, 4, 5], "length": 9, "temperature": 1.0, "top_k": 20, "top_p": 0.9}
    for http_server in (server[0], jax_server[0]):
        events = _post(http_server, body)[1]["events"]
        assert events[:3] == [3, 4, 5] and len(events) == 12
        assert all(0 <= e < VOCAB for e in events)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_midi_base64_matches_the_original(seed):
    ids = np.random.default_rng(seed).integers(0, VOCAB, 200).astype(np.int32)
    assert _midi_base64_from_ids(ids, get_default()) == \
        jax_serving._midi_base64_from_ids(ids, jax_get_default())


@pytest.mark.parametrize("prompt_length", [None, 3, 100])
def test_prompt_from_json_matches_the_original(prompt_length, tmp_path):
    midi = {"midi_base64": base64.b64encode(_midi_bytes(jax_events, NOTES, tmp_path)).decode()}
    for body in ({"events": [4, 5, 6, 7, 8]}, midi):
        ours = _prompt_from_json(body, get_default(), prompt_length)
        theirs = jax_serving._prompt_from_json(body, jax_get_default(), prompt_length)
        assert ours.dtype == theirs.dtype == np.int32
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("index", range(len(BAD_BODIES)))
def test_prompt_errors_match_the_original(index):
    """Each bad body of ``test_bad_requests_are_400`` meets the same error
    class (by name: the packages keep their own) and message in both, or
    passes both, as the bad length and out-of-vocabulary ids do (the
    service refuses those)."""
    body = BAD_BODIES[index]

    def outcome(fn, config):
        try:
            return "ok", fn(body, config, body.get("prompt_length")).tolist()
        except Exception as error:  # the class is what is compared
            return type(error).__name__, str(error)

    ours = outcome(_prompt_from_json, get_default())
    assert ours == outcome(jax_serving._prompt_from_json, jax_get_default())
    if index in (0, 1, 2, 5, 6):
        assert ours[0] == "InvalidParameterError"


def test_midi_prompt_round_trips_through_the_port_codec(tmp_path):
    """A MIDI prompt written by the port's writer and read by its reader
    (``NoteSequence.from_midi``) gives the JAX package's ids for the same
    notes."""
    ours = _prompt_from_json(
        {"midi_base64": base64.b64encode(_midi_bytes(events, NOTES, tmp_path)).decode()},
        get_default(), None)
    config = jax_get_default()
    expected = jax_events.NoteSequence([jax_events.Note(*n) for n in NOTES]).trim_start() \
        .to_event_sequence(config.dataset.time_step_increment, config.dataset.max_time_steps,
                           config.dataset.velocity_bins).to_ids()
    np.testing.assert_array_equal(ours, expected)
    read = events.NoteSequence.from_midi(tmp_path / "prompt.mid")
    assert [(n.start, n.end, n.pitch, n.velocity) for n in read.notes] == NOTES
