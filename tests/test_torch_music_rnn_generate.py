"""MusicRNN generation, the scalar samplers and MusicRNN serving in the port,
against the JAX package (f32, CPU).

Greedy ids of ``generate_ids`` equal JAX's ``_rnn_generate`` exactly;
sampled ids lie in the support the filters allow (torch's generator cannot
replay JAX's); the scalar filters equal JAX's exactly. ``GenerationService``
and ``build_server`` serve MusicRNN on ``device="cpu"``: requests coalesce by
exact prompt length, and every wait is bounded.
"""

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composer_tpu.ops.sampling as jax_sampling
from composer_tpu.models import ModelType as JaxModelType
from composer_tpu.models.music_rnn import MusicRNN as JaxMusicRNN
from composer_tpu.models.music_rnn import MusicRNNConfig as JaxConfig
from composer_tpu.train.generate import generate_ids as jax_generate_ids
from composer_tpu_torch.config import get_default
from composer_tpu_torch.exceptions import InvalidParameterError
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.convert import rnn_params_from_flax
from composer_tpu_torch.models.music_rnn import MusicRNN, MusicRNNConfig
from composer_tpu_torch.ops import sampling
from composer_tpu_torch.serving import ContinuousGenerationService, GenerationService, build_server
from composer_tpu_torch.train import generate as gen

VOCAB = 390  # the default codec's vocabulary, so served events validate
WAIT = 60.0  # seconds: the bound on every blocking wait
_PAIR = {}


def _pair():
    """(JAX model, JAX variables with non-trivial running statistics, port
    model on the same weights): embed 16, two LSTM layers of 24."""
    if not _PAIR:
        common = dict(vocab_size=VOCAB, embed_dim=16, layer_sizes=(24, 24),
                      dropout_rates=(0.0, 0.0))
        jax_model = JaxMusicRNN(JaxConfig(**common))
        variables = jax.tree_util.tree_map(np.asarray, jax.device_get(
            jax_model.init_variables(jax.random.PRNGKey(1), 2, 8)))
        rng = np.random.default_rng(11)
        for stats in variables["batch_stats"].values():
            stats["mean"] = rng.normal(0, 0.1, stats["mean"].shape).astype(np.float32)
            stats["var"] = rng.uniform(0.5, 2.0, stats["var"].shape).astype(np.float32)
        config = MusicRNNConfig(**common)
        model = MusicRNN(config)
        model.load_state_dict(rnn_params_from_flax(variables["params"],
                                                   variables["batch_stats"], config))
        _PAIR["pair"] = (jax_model, variables, model.eval())
    return _PAIR["pair"]


PROMPTS = np.random.default_rng(3).integers(0, VOCAB, (3, 6)).astype(np.int32)


def _jax_greedy():
    """JAX's greedy ids for ``PROMPTS`` (computed once: the scan compiles)."""
    if "greedy" not in _PAIR:
        jax_model, variables, _ = _pair()
        _PAIR["greedy"] = np.asarray(jax_generate_ids(
            jax_model, JaxModelType.MUSIC_RNN, jax.tree_util.tree_map(jnp.asarray, variables),
            PROMPTS, length=24, temperature=0.0))
    return _PAIR["greedy"]


@pytest.mark.parametrize("engine", ["auto", "xla", "megakernel", "spec"])
def test_greedy_ids_equal_jax(engine):
    """Greedy ids equal JAX's exactly, whatever the engine (MusicRNN has one
    path), for a batch and for one prompt given as a vector."""
    _, _, model = _pair()
    expected = _jax_greedy()
    got = gen.generate_ids(model, ModelType.MUSIC_RNN, None, PROMPTS, length=24,
                           temperature=0.0, engine=engine)
    assert got.dtype == np.int32 and got.shape == (3, 30)
    np.testing.assert_array_equal(got, expected)
    one = gen.generate_ids(model, ModelType.MUSIC_RNN, model.state_dict(), PROMPTS[1],
                           length=24, temperature=0.0)
    np.testing.assert_array_equal(one, expected[1])


def _allowed(model, ids, prompt_len, temperature, top_k, top_p):
    """Teacher-forces ``ids`` through the model; returns, for each generated
    position, the mask of tokens the filters allow there."""
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(ids[:, :-1]).long())
    steps = logits[:, prompt_len - 1:].float() / temperature
    flat = steps.reshape(-1, VOCAB)
    rows = flat.shape[0]
    filtered = sampling.filter_top_p_rows(
        sampling.filter_top_k_rows(flat, torch.full((rows,), top_k)),
        torch.full((rows,), top_p))
    return torch.isfinite(filtered).reshape(steps.shape)


@pytest.mark.parametrize("top_k, top_p, temperature", [(5, 0.0, 1.3), (0, 0.6, 0.1),
                                                       (8, 0.7, 0.1)])
def test_sampled_ids_lie_in_the_allowed_support(top_k, top_p, temperature):
    """Every sampled id is one the filters allow after its own prefix (the
    low temperatures sharpen the random model's flat rows, so that the
    nucleus is small)."""
    _, _, model = _pair()

    def sample(seed):
        return gen.generate_ids(model, ModelType.MUSIC_RNN, None, PROMPTS, length=20,
                                temperature=temperature, top_k=top_k, top_p=top_p, seed=seed)

    ids = sample(7)
    allowed = _allowed(model, ids, PROMPTS.shape[1], temperature, top_k, top_p)
    generated = torch.from_numpy(ids[:, PROMPTS.shape[1]:]).long()
    assert bool(allowed.gather(-1, generated[..., None]).all())
    kept = allowed.sum(-1)  # the filters cut
    assert int(kept.max()) <= (top_k or VOCAB) and float(kept.float().mean()) < VOCAB / 4
    if top_k == 5:  # one seed, one stream; two seeds, two
        np.testing.assert_array_equal(sample(7), ids)
        assert not np.array_equal(sample(8), ids)


def test_prompt_lengths_are_refused_for_music_rnn():
    _, _, model = _pair()
    with pytest.raises(ValueError, match="only supported for transformers"):
        gen.generate_ids(model, ModelType.MUSIC_RNN, None, PROMPTS, length=2,
                         prompt_lengths=[6, 6, 6])


# ------------------------------------------------------------- the samplers
def _logits(seed, shape=(4, 50)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, shape).astype(np.float32)
    logits[0, :5] = logits[0, 5]  # ties at the threshold
    return logits


@pytest.mark.parametrize("k", [1, 5, 50])
def test_filter_top_k_equals_jax(k):
    logits = _logits(k)
    expected = np.asarray(jax_sampling.filter_top_k(jnp.asarray(logits), k))
    np.testing.assert_array_equal(sampling.filter_top_k(torch.from_numpy(logits), k).numpy(),
                                  expected)


@pytest.mark.parametrize("p", [0.05, 0.5, 0.9, 0.999])
def test_filter_top_p_equals_jax(p):
    logits = _logits(int(p * 1000))
    expected = np.asarray(jax_sampling.filter_top_p(jnp.asarray(logits), p))
    np.testing.assert_array_equal(sampling.filter_top_p(torch.from_numpy(logits), p).numpy(),
                                  expected)


def test_scalar_samplers():
    """Greedy is the argmax; sampled ids come from the filtered support; a
    scalar setting draws what the row form draws from the same generator."""
    logits = torch.from_numpy(_logits(2))
    argmax = logits.argmax(-1)
    assert torch.equal(sampling.sample_logits(None, logits, 0.0), argmax)
    assert torch.equal(sampling.sample_filtered(None, logits, 0.0, top_k=3, top_p=0.5), argmax)
    assert torch.equal(sampling.sample_top_k(None, logits, -1.0, k=3), argmax)
    for seed in range(20):
        ids = sampling.sample_top_k(torch.Generator().manual_seed(seed), logits, 1.0, k=3)
        assert bool(torch.isfinite(sampling.filter_top_k(logits, 3)).gather(
            -1, ids[:, None]).all())
    rows = logits.shape[0]
    for top_k, top_p in ((0, 0.0), (4, 0.0), (0, 0.7), (6, 0.8)):
        scalar = sampling.sample_filtered(torch.Generator().manual_seed(5), logits, 0.7,
                                          top_k=top_k, top_p=top_p)
        row = sampling.sample_filtered_rows(
            torch.Generator().manual_seed(5), logits, torch.full((rows,), 0.7),
            torch.full((rows,), top_k), torch.full((rows,), top_p))
        assert torch.equal(scalar, row), (top_k, top_p)
    # sample_logits keeps the leading axes and never draws a -inf entry.
    masked = logits[:3, None].clone()
    masked[..., 2:] = -torch.inf
    drawn = sampling.sample_logits(torch.Generator().manual_seed(0), masked)
    assert drawn.shape == (3, 1) and bool((drawn < 2).all())


# --------------------------------------------------------------- serving
def _post(http_server, payload):
    request = urllib.request.Request(
        f"http://127.0.0.1:{http_server.server_port}/v1/generate",
        data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=WAIT) as response:
        return response.status, json.loads(response.read())


def _start(fn, *args):
    thread = threading.Thread(target=fn, args=args, daemon=True)
    thread.start()
    return thread


def test_service_and_server_serve_music_rnn(monkeypatch):
    """Three greedy requests queued while the worker is held on a fourth:
    the two prompts of 3 events share a batch, the one of 5 runs apart (no
    ragged prompts for the RNN), and every response equals a lone greedy
    ``generate_ids``. ``/v1/health`` reports the model type."""
    _, _, model = _pair()
    service = GenerationService(model, ModelType.MUSIC_RNN, None, VOCAB, max_batch_size=4,
                                max_wait_ms=300.0, device="cpu")
    http_server = build_server(service, get_default(), port=0, default_length=6)
    server_thread = _start(http_server.serve_forever)
    entered, release = threading.Event(), threading.Event()
    real = gen.generate_ids

    def gated(*args, **kwargs):
        if not entered.is_set():
            entered.set()
            assert release.wait(timeout=WAIT)
        return real(*args, **kwargs)

    monkeypatch.setattr(gen, "generate_ids", gated)
    try:
        blocker = _start(_post, http_server, {"events": [9], "length": 1, "temperature": 0.0})
        assert entered.wait(timeout=WAIT)
        prompts = [[5, 6, 7], [8, 9, 10], [1, 2, 3, 4, 5]]
        results = [None] * 3

        def call(i):
            results[i] = _post(http_server, {"events": prompts[i], "length": 5,
                                             "temperature": 0.0})

        threads = [_start(call, i) for i in range(3)]
        limit = time.monotonic() + WAIT
        while service.overload_stats()["queue_depth"] != 3:
            assert time.monotonic() < limit, "the queue never held the requests"
            time.sleep(0.01)
        release.set()
        for thread in [blocker] + threads:
            thread.join(timeout=WAIT)
            assert not thread.is_alive()
        assert sorted(service.batch_sizes[1:]) == [1, 2]
        for prompt, (status, body) in zip(prompts, results):
            assert status == 200
            expected = real(model, ModelType.MUSIC_RNN, None, np.asarray(prompt), length=5,
                            temperature=0.0)
            assert body["events"] == expected.tolist()
        with urllib.request.urlopen(f"http://127.0.0.1:{http_server.server_port}/v1/health",
                                    timeout=WAIT) as response:
            health = json.loads(response.read())
        assert health["model_type"] == "music_rnn" and health["backend"] == "cpu"
        assert health["requests_served"] == 4
    finally:
        release.set()
        http_server.shutdown()
        http_server.server_close()
        service.close()
        server_thread.join(timeout=WAIT)


def test_continuous_service_refuses_music_rnn():
    _, _, model = _pair()
    with pytest.raises(InvalidParameterError, match="requires a transformer model"):
        ContinuousGenerationService(model, ModelType.MUSIC_RNN, None, VOCAB, device="cpu")
