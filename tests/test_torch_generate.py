"""The port's ``generate_ids`` and ``TransformerDecoder`` against the JAX
package's ``generate_ids`` (f32 greedy ids must be equal, CPU)."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from composer_tpu.models import ModelType as JaxModelType
from composer_tpu.models.transformer import Transformer as JaxTransformer
from composer_tpu.models.transformer import TransformerConfig as JaxConfig
from composer_tpu.train.generate import generate_ids as jax_generate_ids
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.convert import params_from_flax
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.train import generate as gen

PROMPTS = np.array([[5, 100, 300, 17, 42], [9, 42, 7, 250, 3]], np.int32)


@pytest.fixture(scope="module", params=[False, True], ids=["abs", "rel"])
def setup(request):
    kwargs = dict(
        vocab_size=390, embed_dim=64, window_size=32, num_layers=2, num_heads=4,
        use_relative_attention=request.param, attention_dropout_rate=0.0,
        residual_dropout_rate=0.0, initializer_stddev=0.3,
    )
    jax_model = JaxTransformer(JaxConfig(**kwargs))
    params = jax_model.init_params(jax.random.PRNGKey(0), 1, 8)
    model = Transformer(TransformerConfig(**kwargs))
    model.load_state_dict(params_from_flax(jax.device_get(params), model.config))
    return jax_model, params, model


def _jax_greedy(jax_model, params, prompts, length, **kwargs):
    return np.asarray(jax_generate_ids(
        jax_model, JaxModelType.TRANSFORMER, params, prompts, length=length,
        temperature=0.0, engine="xla", **kwargs,
    ))


def test_unfused_greedy_matches_jax(setup):
    jax_model, params, model = setup
    expected = _jax_greedy(jax_model, params, PROMPTS, 12)
    out = gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS, length=12,
                           temperature=0.0, engine="xla")
    assert out.shape == (2, 17) and out.dtype == np.int32
    np.testing.assert_array_equal(out, expected)
    assert len(set(out[:, 5:].ravel().tolist())) > 3


def test_unfused_ragged_greedy_matches_jax(setup):
    jax_model, params, model = setup
    plens = np.array([5, 2], np.int32)
    expected = _jax_greedy(jax_model, params, PROMPTS, 10, prompt_lengths=plens)
    out = gen.generate_ids(model, ModelType.TRANSFORMER, model.state_dict(), PROMPTS,
                           length=10, temperature=0.0, engine="xla", prompt_lengths=plens)
    np.testing.assert_array_equal(out, expected)


def test_unfused_greedy_across_cache_stages_matches_jax(setup):
    """A generation that grows the staged cache (256 -> 512) and runs past
    the window."""
    jax_model, params, model = setup
    prompt = PROMPTS[:1]
    expected = _jax_greedy(jax_model, params, prompt, 260)
    out = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompt, length=260,
                           temperature=0.0, engine="xla")
    np.testing.assert_array_equal(out, expected)


@pytest.mark.parametrize("prefill_min", ["64", "3"])
def test_decoder_greedy_matches_jax(setup, monkeypatch, prefill_min):
    """The fused engine (plain version on the CPU) with and without the
    parallel prefill of the common prompt prefix, at batch 2 and batch 1."""
    jax_model, params, model = setup
    monkeypatch.setenv("COMPOSER_PREFILL_MIN", prefill_min)
    decoder = gen.TransformerDecoder(model, dtype=torch.float32)
    plens = np.array([5, 4], np.int32)
    expected = _jax_greedy(jax_model, params, PROMPTS, 10, prompt_lengths=plens)
    out = decoder.generate(PROMPTS, 10, temperature=0.0, prompt_lengths=plens)
    np.testing.assert_array_equal(out.numpy(), expected[:, 5:])
    single = decoder.generate(PROMPTS[:1], 10, temperature=0.0)
    np.testing.assert_array_equal(single.numpy(), _jax_greedy(jax_model, params,
                                                              PROMPTS[:1], 10)[:, 5:])


def test_sampled_generation_is_seeded(setup):
    _, _, model = setup
    for engine in ("xla", "megakernel"):
        kwargs = dict(length=9, temperature=np.array([1.0, 0.8], np.float32), top_k=40,
                      top_p=0.9, seed=5, engine=engine)
        first = gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS, **kwargs)
        again = gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS, **kwargs)
        np.testing.assert_array_equal(first, again)
        np.testing.assert_array_equal(first[:, :5], PROMPTS)
        assert first.shape == (2, 14) and (first >= 0).all() and (first < 390).all()


def test_engine_repacks_weights_changed_in_place():
    """The cached packed engine follows in-place weight updates of the
    module it was built from (load_state_dict, reset_parameters)."""
    model = Transformer(TransformerConfig(vocab_size=390, embed_dim=64, window_size=32,
                                          num_layers=2, num_heads=4, initializer_stddev=0.3))
    model.reset_parameters(torch.Generator().manual_seed(0))
    kwargs = dict(length=8, temperature=0.0, engine="megakernel")
    first = gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS, **kwargs)
    engine = gen._ENGINE_CACHE["engine"]
    assert gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS, **kwargs).tolist() \
        == first.tolist() and gen._ENGINE_CACHE["engine"] is engine
    for update in ("reset_parameters", "load_state_dict"):
        other = Transformer(model.config)
        other.reset_parameters(torch.Generator().manual_seed(7))
        if update == "reset_parameters":
            model.reset_parameters(torch.Generator().manual_seed(7))
        else:
            model.reset_parameters(torch.Generator().manual_seed(0))
            gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS, **kwargs)
            model.load_state_dict(other.state_dict())
        changed = gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS, **kwargs)
        expected = gen.TransformerDecoder(other).generate(PROMPTS, 8, temperature=0.0)
        np.testing.assert_array_equal(changed[:, 5:], expected.numpy(), err_msg=update)
        assert not np.array_equal(changed, first), update


def test_routing(setup, monkeypatch):
    _, _, model = setup
    calls = []
    monkeypatch.setattr(gen.TransformerDecoder, "generate",
                        lambda self, prompt, length, **kw: calls.append(prompt.shape)
                        or torch.zeros((prompt.shape[0], length), dtype=torch.int32))
    # auto on the CPU takes the unfused path; megakernel takes the engine.
    gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS, length=3, engine="auto")
    assert calls == []
    out = gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS[0], length=3,
                           engine="megakernel")
    assert calls == [(1, 5)] and out.shape == (8,)
    device = torch.device("cuda")
    assert gen._use_kernel(model, ModelType.TRANSFORMER, 1024, "auto", device)
    assert not gen._use_kernel(model, ModelType.TRANSFORMER, 1024, "xla", device)
    # The kernel's one limit: the scores of a 40k-slot cache exceed shared memory.
    assert not gen._use_kernel(model, ModelType.TRANSFORMER, 40_000, "auto", device)
    # auto sends weights beyond the card's L2 (the Hopper value without a
    # CUDA runtime) to the wide kernel: the embed-1024 flagship (about 200 MB
    # packed) but not the default model (about 12.6 MB); on the CPU auto
    # stays unfused.
    if not torch.cuda.is_available():
        assert gen._fast_memory_bytes(device) == 50 * 2**20
    flagship = SimpleNamespace(config=TransformerConfig(
        vocab_size=390, embed_dim=1024, window_size=2048, num_layers=8, num_heads=16,
        use_relative_attention=True))
    default = SimpleNamespace(config=TransformerConfig(vocab_size=390))
    for routed, wide, kernel in ((flagship, True, False), (default, False, True)):
        assert gen._use_wide_kernel(routed, ModelType.TRANSFORMER, 1024, "auto",
                                    device) is wide
        assert gen._use_wide_kernel(routed, ModelType.TRANSFORMER, 1024, "wide", device)
        assert not gen._use_wide_kernel(routed, ModelType.TRANSFORMER, 1024, "megakernel",
                                        device)
        assert gen._use_spec_kernel(routed, ModelType.TRANSFORMER, 1, 1024, "auto", device,
                                    np.zeros(1)) is kernel
    assert not gen._use_wide_kernel(flagship, ModelType.TRANSFORMER, 1024, "auto",
                                    torch.device("cpu"))
    wide_calls = []
    monkeypatch.setattr(gen.WideTransformerDecoder, "generate",
                        lambda self, prompt, length, **kw: wide_calls.append(prompt.shape)
                        or torch.zeros((prompt.shape[0], length), dtype=torch.int32))
    gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS, length=3, engine="wide")
    assert wide_calls == [(2, 5)] and calls == [(1, 5)]
    # spec at batch 2 takes the unfused path, as the JAX gates send it.
    gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS, length=3, engine="spec")
    assert calls == [(1, 5)]
    with pytest.raises(ValueError, match="unknown engine"):
        gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPTS, length=3, engine="fast")


def test_normalize_sampling_and_cache_padding():
    temps, ks, ps = gen._normalize_sampling(3, 0.5, [1, 2, 3], 0.9)
    assert temps.tolist() == [0.5] * 3 and ks.tolist() == [1, 2, 3]
    np.testing.assert_allclose(ps, 0.9)
    with pytest.raises(ValueError, match="length-3"):
        gen._normalize_sampling(3, [1.0, 2.0], 0, 0.0)
    assert [gen._padded_cache_len(n) for n in (1, 128, 129, 1024, 1025)] == [
        128, 128, 256, 1024, 1152]
