"""The port's speculative decoding (``ops/decode_kernel_spec.py``) against the
JAX package's ``speculative_generate`` in Pallas interpret mode, and its
routing through ``generate_ids`` (CPU, float32).

On the CPU the wrapper runs its plain PyTorch version. Greedy tokens and
stats must equal the JAX kernel's exactly; greedy tokens must also equal the
unfused path and the port's sequential plain version. Sampled ids must equal
the port's sequential plain version for the same seed: both draw the Philox
noise of (seed, row 0, position). That property is the port's own; the JAX
kernel draws its block's noise from the TPU PRNG and only matches the
sequential kernel in distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composer_tpu.models import ModelType as JaxModelType
from composer_tpu.models.transformer import Transformer as JaxTransformer
from composer_tpu.models.transformer import TransformerConfig as JaxConfig
from composer_tpu.ops import decode_kernel as jax_dk
from composer_tpu.ops import decode_kernel_spec as jax_spec
from composer_tpu.train.generate import generate_ids as jax_generate_ids
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.convert import params_from_flax
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops import decode_kernel_spec as dks
from composer_tpu_torch.train import generate as gen

PROMPT = np.array([5, 60, 30, 17, 88, 3, 44], np.int32)
_MODELS = {}


def _setup(use_relative=False, stddev=0.3, seed=0, num_layers=1):
    """The JAX test's small model (tests/test_decode_spec.py:23), its weights
    carried into the port: (jax model, jax params, port model, f32 packed)."""
    key = (use_relative, stddev, seed, num_layers)
    if key not in _MODELS:
        kwargs = dict(vocab_size=96, embed_dim=32, window_size=48, num_layers=num_layers,
                      num_heads=2, use_relative_attention=use_relative,
                      attention_dropout_rate=0.0, residual_dropout_rate=0.0,
                      initializer_stddev=stddev)
        jax_model = JaxTransformer(JaxConfig(**kwargs, dtype=jnp.float32,
                                             param_dtype=jnp.float32))
        params = jax_model.init_params(jax.random.PRNGKey(seed), 1, 8)
        model = Transformer(TransformerConfig(**kwargs), device="cpu")
        model.load_state_dict(params_from_flax(jax.device_get(params), model.config))
        packed = dk.pack_weights(model.state_dict(), model.config, dtype=torch.float32)
        _MODELS[key] = (jax_model, params, model.eval(), packed)
    return _MODELS[key]


def _jax_spec(setup, prompt, length, cache_len=None, **kwargs):
    """JAX tokens and stats; the JAX kernel writes stats[0:3] only (its
    interpreter leaves the rest unset), the port writes zeros there."""
    jax_model, params, _, _ = setup
    packed = jax_dk.pack_weights(params, jax_model.config, dtype=jnp.float32)
    tokens, stats = jax_spec.speculative_generate(
        packed, prompt, 0, 0.0, config=jax_model.config, length=length,
        cache_len=cache_len or prompt.shape[0] + length, interpret=True, **kwargs,
    )
    return np.asarray(tokens), np.concatenate([np.asarray(stats)[:3], np.zeros(5, np.int32)])


def _port_spec(setup, prompt, length, cache_len=None, seed=0, temperature=0.0, **kwargs):
    _, _, model, packed = setup
    tokens, stats = dks.speculative_generate(
        packed, prompt, seed, temperature, config=model.config, length=length,
        cache_len=cache_len or prompt.shape[0] + length, **kwargs,
    )
    return tokens.numpy(), stats.numpy()


def _xla_greedy(setup, prompt, length):
    jax_model, params, _, _ = setup
    out = jax_generate_ids(jax_model, JaxModelType.TRANSFORMER, params, prompt[None],
                           length=length, temperature=0.0, seed=0, engine="xla")
    return np.asarray(out[0, prompt.shape[0]:])


@pytest.mark.parametrize("use_relative,block,num_layers",
                         [(False, 2, 1), (False, 5, 1), (True, 5, 2), (True, 16, 1)])
def test_greedy_matches_jax_kernel_xla_and_sequential(use_relative, block, num_layers):
    setup = _setup(use_relative, num_layers=num_layers)
    expected, jax_stats = _jax_spec(setup, PROMPT, 24, block=block)
    tokens, stats = _port_spec(setup, PROMPT, 24, block=block)
    np.testing.assert_array_equal(tokens, expected)
    np.testing.assert_array_equal(stats, jax_stats)
    assert stats[0] >= 1 and stats[2] >= PROMPT.shape[0] - 1 + 24
    np.testing.assert_array_equal(tokens, _xla_greedy(setup, PROMPT, 24))
    _, _, model, packed = setup
    sequential = dk.megakernel_generate(packed, PROMPT, 0, 0.0, config=model.config,
                                        length=24, cache_len=PROMPT.shape[0] + 24)
    np.testing.assert_array_equal(tokens, sequential.numpy())
    assert len(set(tokens.tolist())) > 1


def test_accepts_on_repetitive_stream():
    """Near-zero weights give a near-constant greedy stream, which the n-gram
    draft predicts: far fewer generation blocks than tokens, and at T = 6
    exactly (36 - 12) / 6 more generation blocks from length 12 to 36 (a
    fully matched block emits all T tokens)."""
    setup = _setup(stddev=1e-3, seed=1)
    prompt = np.array([3, 3, 3], np.int32)
    tokens, stats = _port_spec(setup, prompt, 32)
    expected, jax_stats = _jax_spec(setup, prompt, 32)
    np.testing.assert_array_equal(tokens, expected)
    np.testing.assert_array_equal(stats, jax_stats)
    assert stats[1] < 32 / 2, stats
    gen_blocks = {length: _port_spec(setup, prompt, length, block=6)[1][1]
                  for length in (12, 36)}
    assert gen_blocks[36] - gen_blocks[12] == (36 - 12) // 6, gen_blocks


@pytest.mark.parametrize("prompt,length,cache_len", [
    (np.array([42], np.int32), 17, None),  # plen 1
    (np.arange(30, dtype=np.int32) * 7 % 96, 6, None),  # plen >= T
    (np.arange(10, dtype=np.int32) * 5 % 96, 22, 32),  # plen + length == cache_len
], ids=["plen1", "long_prompt", "full_cache"])
def test_prompt_edge_cases_match_jax_kernel(prompt, length, cache_len):
    setup = _setup()
    expected, jax_stats = _jax_spec(setup, prompt, length, cache_len)
    tokens, stats = _port_spec(setup, prompt, length, cache_len)
    np.testing.assert_array_equal(tokens, expected)
    np.testing.assert_array_equal(stats, jax_stats)


def test_rejects_overflow_and_bad_blocks(monkeypatch):
    setup = _setup()
    with pytest.raises(ValueError, match="exceeds cache"):
        _port_spec(setup, np.zeros(20, np.int32), 20, cache_len=30)
    for block in (1, 17):
        with pytest.raises(ValueError, match="block"):
            _port_spec(setup, np.zeros(4, np.int32), 8, cache_len=64, block=block)
    for bad in ("banana", "0", "1", "17", "-3"):
        monkeypatch.setenv("COMPOSER_SPEC_BLOCK", bad)
        with pytest.raises(ValueError, match="COMPOSER_SPEC_BLOCK"):
            dks._parse_block_env()
    monkeypatch.setenv("COMPOSER_SPEC_BLOCK", "8")
    assert dks._parse_block_env() == 8
    monkeypatch.delenv("COMPOSER_SPEC_BLOCK")
    assert dks._parse_block_env() is None
    assert (dks.default_block(True), dks.default_block(False)) == (5, 3)


@pytest.mark.parametrize("use_relative", [False, True], ids=["abs", "rel"])
def test_teacher_forced_logits_match_model_and_greedy_tokens(use_relative):
    """``teacher_forced_logits`` (the plain forward over a whole stream,
    which the card's bf16 check feeds the kernel's output through) equals
    the model's forward in f32, and every greedy speculative token is the
    top of its teacher-forced row."""
    _, _, model, packed = _setup(use_relative=use_relative, num_layers=2)
    tokens, _ = _port_spec(_setup(use_relative=use_relative, num_layers=2), PROMPT, 30,
                           cache_len=48)
    stream = np.concatenate([PROMPT, tokens])
    logits = dks.teacher_forced_logits(packed, stream, config=model.config)
    assert logits.shape == (stream.size, packed["wte"].shape[0])
    with torch.no_grad():
        expected, _ = model(torch.as_tensor(stream[None], dtype=torch.long))
    vocab = model.config.vocab_size
    np.testing.assert_allclose(logits[:, :vocab].numpy(), expected[0].numpy(), atol=2e-4)
    rows = logits[PROMPT.size - 1:-1, :vocab]
    gap = rows.max(-1).values - rows[torch.arange(tokens.size), torch.as_tensor(tokens).long()]
    assert float(gap.max()) <= 1e-5, gap


@pytest.mark.parametrize("block,largest", [(3, 2671), (5, 2338), (11, 1157)])
def test_kernel_limit_counts_static_shared_memory(block, largest):
    """``spec_kernel_fits`` states the card's limit with the kernel's static
    shared state (``BlockState``: 132 bytes, 144 with the dynamic buffer's
    16-byte alignment) beside the dynamic buffer: one
    cache length more needs more than a block may have, while the dynamic
    part alone would still fit at the block-5 boundary."""
    default = TransformerConfig(vocab_size=390)
    assert dks.spec_kernel_fits(default, largest, block)
    assert not dks.spec_kernel_fits(default, largest + 1, block)
    beyond = dks.spec_smem_bytes(default, largest + 1, block)
    assert beyond > dks.MAX_SHARED_BYTES
    if block == 5:
        assert beyond - dks.SPEC_STATIC_SHARED_BYTES <= dks.MAX_SHARED_BYTES


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (12, 0.9)], ids=["plain", "filtered"])
def test_sampled_ids_equal_sequential_plain_version(seed, top_k, top_p):
    """The port's own property: row t of a block draws the noise of row 0 at
    step p0 + t, so every emitted sample equals the sequential sample."""
    _, _, model, packed = _setup(use_relative=bool(seed % 2))
    kwargs = dict(config=model.config, length=30, cache_len=48, top_k=top_k, top_p=top_p)
    tokens, stats = dks.speculative_generate(packed, PROMPT, seed, 0.9, **kwargs)
    sequential = dk.megakernel_generate(packed, PROMPT, seed, 0.9, **kwargs)
    np.testing.assert_array_equal(tokens.numpy(), sequential.numpy())
    assert stats[1] <= 30


def test_generate_ids_routing_on_the_cpu():
    _, _, model, _ = _setup()
    gen._ENGINE_CACHE["engine"] = gen.TransformerDecoder(model, dtype=torch.float32)
    xla = gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPT[None], length=16,
                           temperature=0.0, engine="xla")
    before = gen.SPEC_DISPATCHES
    spec = gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPT[None], length=16,
                            temperature=0.0, engine="spec")
    assert gen.SPEC_DISPATCHES == before + 1
    assert gen.LAST_SPEC_STATS is not None and gen.LAST_SPEC_STATS[0] >= 1
    np.testing.assert_array_equal(spec, xla)
    # Sampled spec runs on the CPU too (the JAX package raises there) and
    # gives the fused engine's ids.
    sampled = {engine: gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPT, length=16,
                                        temperature=1.0, seed=3, engine=engine)
               for engine in ("spec", "megakernel")}
    np.testing.assert_array_equal(sampled["spec"], sampled["megakernel"])
    assert gen.SPEC_DISPATCHES == before + 2
    # Batch 2 takes the unfused path; auto on the CPU never takes spec.
    batch2 = np.tile(PROMPT, (2, 1))
    np.testing.assert_array_equal(
        gen.generate_ids(model, ModelType.TRANSFORMER, None, batch2, length=8,
                         temperature=0.0, engine="spec"),
        gen.generate_ids(model, ModelType.TRANSFORMER, None, batch2, length=8,
                         temperature=0.0, engine="xla"))
    gen.generate_ids(model, ModelType.TRANSFORMER, None, PROMPT, length=8,
                     temperature=0.0, engine="auto")
    assert gen.SPEC_DISPATCHES == before + 2


def test_use_spec_kernel_gate():
    """The JAX gate with the device faked to CUDA: auto takes spec only for
    greedy batch 1 with layer norm and a cache that fits (the route kept by
    the H100 measurement in ``_use_spec_kernel``'s docstring); spec opts in."""
    _, _, model, _ = _setup()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    greedy, sampled = np.zeros(1, np.float32), np.full(1, 0.9, np.float32)
    use = gen._use_spec_kernel
    assert use(model, ModelType.TRANSFORMER, 1, 48, "auto", cuda, greedy)
    assert not use(model, ModelType.TRANSFORMER, 1, 48, "auto", cuda, sampled)
    assert not use(model, ModelType.TRANSFORMER, 2, 48, "auto", cuda, np.zeros(2))
    assert not use(model, ModelType.TRANSFORMER, 1, 40_000, "auto", cuda, greedy)
    assert not use(model, ModelType.TRANSFORMER, 1, 48, "auto", cpu, greedy)
    assert not use(model, ModelType.TRANSFORMER, 1, 48, "megakernel", cuda, greedy)
    assert use(model, ModelType.TRANSFORMER, 1, 48, "spec", cuda, sampled)
    assert use(model, ModelType.TRANSFORMER, 1, 48, "spec", cpu, greedy)
    norm_free = Transformer(TransformerConfig(vocab_size=96, embed_dim=32, window_size=48,
                                              num_layers=1, num_heads=2,
                                              use_layer_norm=False), device="cpu")
    assert not use(norm_free, ModelType.TRANSFORMER, 1, 48, "auto", cuda, greedy)
    # Default model: block 5 fits cache 1024; no block above 11 does.
    default = TransformerConfig(vocab_size=390)
    assert dks.spec_kernel_fits(default, 1024, 5) and dks.spec_kernel_fits(default, 1024, 11)
    assert not dks.spec_kernel_fits(default, 1024, 12)
