"""The port's fused decode path against the JAX package (f32, CPU).

On the CPU the kernel wrappers run their plain PyTorch version, so these
tests hold that version against the Pallas kernels in interpret mode and
the XLA engine. The card's kernel is compared with the plain version by
``chip_smoke.py`` and ``tests/test_torch_cuda_kernel.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from composer_tpu.models import ModelType as JaxModelType
from composer_tpu.models.transformer import Transformer as JaxTransformer
from composer_tpu.models.transformer import TransformerConfig as JaxConfig
from composer_tpu.models.transformer import init_cache as jax_init_cache
from composer_tpu.ops import decode_kernel as jdk
from composer_tpu.ops import sampling as jsampling
from composer_tpu.ops.decode_kernel_batched import (
    megakernel_generate_batched as jax_generate_batched,
)
from composer_tpu.train.generate import generate_ids as jax_generate_ids
from composer_tpu_torch.models.convert import params_from_flax
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig, init_cache
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops import sampling
from composer_tpu_torch.ops.decode_kernel_batched import megakernel_generate_batched

PROMPTS = np.array([[5, 100, 300, 17], [9, 42, 7, 250], [1, 2, 3, 4]], np.int32)


@functools.lru_cache(maxsize=None)
def _setup(use_relative, window=64):
    kwargs = dict(
        vocab_size=390, embed_dim=64, window_size=window, num_layers=2, num_heads=4,
        use_relative_attention=use_relative, attention_dropout_rate=0.0,
        residual_dropout_rate=0.0,
        initializer_stddev=0.3,  # varied logits so greedy decoding is non-trivial
    )
    jax_model = JaxTransformer(JaxConfig(**kwargs))
    params = jax.device_get(jax_model.init_params(jax.random.PRNGKey(0), 1, 8))
    config = TransformerConfig(**kwargs)
    model = Transformer(config)
    state = params_from_flax(params, config)
    model.load_state_dict(state)
    return jax_model, params, config, model, state


@pytest.fixture(scope="module", params=[False, True], ids=["abs", "rel"])
def setup(request):
    return _setup(request.param)


def test_pack_weights_matches_jax(setup):
    jax_model, params, config, _, state = setup
    expected = jdk.pack_weights(params, jax_model.config, dtype=jnp.float32)
    packed = dk.pack_weights(state, config, dtype=torch.float32)
    assert set(packed) == set(expected)
    for name, value in expected.items():
        assert tuple(packed[name].shape) == value.shape, name
        np.testing.assert_allclose(packed[name].numpy(), np.asarray(value), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert packed["wte"].shape[0] == 512  # vocab 390 padded to 256s


def test_cache_to_rows_matches_jax(setup):
    jax_model, params, config, model, _ = setup
    prompt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    jcache = jax_init_cache(jax_model.config, 2, 16)
    _, jcache = jax_model.apply({"params": params}, jnp.asarray(prompt), jcache)
    cache = init_cache(config, 2, 16)
    with torch.no_grad():
        _, cache = model(torch.as_tensor(prompt).long(), cache)
    expected = jdk.cache_to_rows_batched(jcache, jax_model.config, 32, dtype=jnp.float32)
    rows = dk.cache_to_rows_batched(cache, config, 32, dtype=torch.float32)
    for ours, theirs in zip(rows, expected):
        assert tuple(ours.shape) == theirs.shape == (2, 64, 64)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-4)


def test_batched_greedy_matches_jax_kernel_and_xla(setup):
    jax_model, params, config, _, state = setup
    jpacked = jdk.pack_weights(params, jax_model.config, dtype=jnp.float32)
    expected = np.asarray(jax_generate_batched(
        jpacked, PROMPTS, 0, 0.0, config=jax_model.config, length=10, cache_len=128,
        interpret=True,
    ))
    xla = np.asarray(jax_generate_ids(
        jax_model, JaxModelType.TRANSFORMER, params, PROMPTS, length=10, temperature=0.0,
        engine="xla",
    ))[:, PROMPTS.shape[1]:]
    np.testing.assert_array_equal(expected, xla)
    packed = dk.pack_weights(state, config, dtype=torch.float32)
    out = megakernel_generate_batched(packed, PROMPTS, 0, 0.0, config=config, length=10,
                                      cache_len=128)
    np.testing.assert_array_equal(out.numpy(), expected)
    assert len(set(expected.ravel().tolist())) > 3


def test_single_greedy_matches_jax_kernel(setup):
    jax_model, params, config, _, state = setup
    jpacked = jdk.pack_weights(params, jax_model.config, dtype=jnp.float32)
    prompt = PROMPTS[0]
    expected = np.asarray(jdk.megakernel_generate(
        jpacked, prompt, seed=0, temperature=0.0, config=jax_model.config, length=12,
        cache_len=128, interpret=True,
    ))
    packed = dk.pack_weights(state, config, dtype=torch.float32)
    out = dk.megakernel_generate(packed, prompt, 0, 0.0, config=config, length=12,
                                 cache_len=128)
    np.testing.assert_array_equal(out.numpy(), expected)
    # Filters never move a greedy argmax.
    filtered = dk.megakernel_generate(packed, prompt, 0, 0.0, config=config, length=12,
                                      cache_len=128, top_k=5, top_p=0.9)
    np.testing.assert_array_equal(filtered.numpy(), expected)


def test_megakernel_decode_from_prefilled_cache_matches_jax(setup):
    jax_model, params, config, model, state = setup
    prompt = PROMPTS[:1]
    xla = np.asarray(jax_generate_ids(
        jax_model, JaxModelType.TRANSFORMER, params, prompt, length=11, temperature=0.0,
        engine="xla",
    ))[0, prompt.shape[1]:]
    cache = init_cache(config, 1, 128)
    with torch.no_grad():
        _, cache = model(torch.as_tensor(prompt).long(), cache)
    packed = dk.pack_weights(state, config, dtype=torch.float32)
    k_rows, v_rows = dk.cache_to_rows(cache, config, 128, dtype=torch.float32)
    out = dk.megakernel_decode(packed, k_rows, v_rows, start_pos=4, token0=int(xla[0]),
                               seed=0, temperature=0.0, config=config, num_steps=10,
                               cache_len=128)
    np.testing.assert_array_equal(out.numpy(), xla[1:])


@pytest.mark.parametrize("use_relative", [False, True])
def test_ragged_prompts_match_jax_kernel(use_relative):
    jax_model, params, config, _, state = _setup(use_relative)
    jpacked = jdk.pack_weights(params, jax_model.config, dtype=jnp.float32)
    plens = np.array([4, 1, 7, 3], np.int32)
    prompts = np.random.default_rng(3).integers(0, 390, (4, 7)).astype(np.int32)
    expected = np.asarray(jax_generate_batched(
        jpacked, prompts, 0, 0.0, config=jax_model.config, length=10, cache_len=128,
        interpret=True, prompt_lengths=plens,
    ))
    packed = dk.pack_weights(state, config, dtype=torch.float32)
    out = megakernel_generate_batched(packed, prompts, 0, 0.0, config=config, length=10,
                                      cache_len=128, prompt_lengths=plens)
    np.testing.assert_array_equal(out.numpy(), expected)


@pytest.mark.parametrize("use_relative", [False, True])
def test_generation_past_window_matches_jax_kernel(use_relative):
    """Past the window, positions clamp and out-of-table distances give no
    relative bias."""
    jax_model, params, config, _, state = _setup(use_relative, window=16)
    jpacked = jdk.pack_weights(params, jax_model.config, dtype=jnp.float32)
    expected = np.asarray(jdk.megakernel_generate(
        jpacked, PROMPTS[0], seed=0, temperature=0.0, config=jax_model.config, length=28,
        cache_len=128, interpret=True,
    ))
    packed = dk.pack_weights(state, config, dtype=torch.float32)
    out = dk.megakernel_generate(packed, PROMPTS[0], 0, 0.0, config=config, length=28,
                                 cache_len=128)
    np.testing.assert_array_equal(out.numpy(), expected)
    assert len(set(expected.tolist())) > 1


def test_start_step_prefill_import_matches_full_loop(setup):
    """Rows [0, start) from one batched forward give the same greedy ids as
    teacher-forcing the prefix in the loop, and as the JAX kernel."""
    jax_model, params, config, model, state = setup
    packed = dk.pack_weights(state, config, dtype=torch.float32)
    prompts = np.random.default_rng(5).integers(0, 390, (3, 9)).astype(np.int32)
    plens = np.array([9, 7, 8], np.int32)
    expected = np.asarray(jax_generate_batched(
        jdk.pack_weights(params, jax_model.config, dtype=jnp.float32), prompts, 0, 0.0,
        config=jax_model.config, length=8, cache_len=128, interpret=True,
        prompt_lengths=plens,
    ))
    full = megakernel_generate_batched(packed, prompts, 0, 0.0, config=config, length=8,
                                       cache_len=128, prompt_lengths=plens)
    np.testing.assert_array_equal(full.numpy(), expected)
    start = 5
    cache = init_cache(config, 3, start)
    with torch.no_grad():
        _, cache = model(torch.as_tensor(prompts[:, :start]).long(), cache)
    rows = dk.cache_to_rows_batched(cache, config, 128, dtype=torch.float32)
    out = megakernel_generate_batched(packed, prompts, 0, 0.0, config=config, length=8,
                                      cache_len=128, prompt_lengths=plens,
                                      prefill_rows=rows, start_step=start)
    np.testing.assert_array_equal(out.numpy(), full.numpy())


def test_batched_validation():
    _, _, config, _, state = _setup(False)
    packed = dk.pack_weights(state, config, dtype=torch.float32)
    prompts = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="prompt_lengths"):
        megakernel_generate_batched(packed, prompts, 0, 0.0, config=config, length=4,
                                    cache_len=128, prompt_lengths=np.array([4, 5]))
    with pytest.raises(ValueError, match="prompt_lengths"):
        megakernel_generate_batched(packed, prompts, 0, 0.0, config=config, length=4,
                                    cache_len=128, prompt_lengths=np.array([4]))
    with pytest.raises(ValueError, match="requires prefill_rows"):
        megakernel_generate_batched(packed, prompts, 0, 0.0, config=config, length=4,
                                    cache_len=128, start_step=2)
    rows = (torch.zeros(2, 256, 64), torch.zeros(2, 256, 64))
    with pytest.raises(ValueError, match="min prompt length"):
        megakernel_generate_batched(packed, prompts, 0, 0.0, config=config, length=4,
                                    cache_len=128, prompt_lengths=np.array([4, 2]),
                                    prefill_rows=rows, start_step=2)
    with pytest.raises(ValueError, match="exceeds cache"):
        megakernel_generate_batched(packed, prompts, 0, 0.0, config=config, length=125,
                                    cache_len=128)


def test_kernel_limit_counts_static_shared_memory():
    """``kernel_fits`` states the card's limit with the kernel's static
    shared ``s_token`` beside the dynamic buffer: for the default model the
    dynamic part alone fits cache 3068, the block as a whole does not."""
    from composer_tpu_torch.ops import decode_kernel_batched as dkb

    default = TransformerConfig(vocab_size=390)
    assert dkb.kernel_fits(default, 3067) and not dkb.kernel_fits(default, 3068)
    assert (dkb.kernel_smem_bytes(default, 3068) - dkb.STATIC_SHARED_BYTES
            <= dkb.MAX_SHARED_BYTES)


# cudaOccupancyMaxActiveClusters-like counts for 132 SMs: 16-block clusters
# fit fewer times than 132 / 16 (a GPC may hold fewer than 16 free SMs).
_SEVEN_OF_16 = {16: 7, 8: 16, 4: 33, 2: 66}
_EIGHT_OF_16 = {16: 8, 8: 16, 4: 33, 2: 66}


@pytest.mark.parametrize("batch, heads, max_active, expected", [
    (1, 16, _SEVEN_OF_16, 16),
    (8, 16, _SEVEN_OF_16, 8),    # 8 clusters of 16 would not all be resident
    (8, 16, _EIGHT_OF_16, 16),
    (16, 16, _SEVEN_OF_16, 8),
    (32, 16, _SEVEN_OF_16, 4),
    (33, 16, _SEVEN_OF_16, 4),   # 33 x 4 = 132 SMs
    (34, 16, _SEVEN_OF_16, 2),
    (64, 16, _SEVEN_OF_16, 2),
    (66, 16, _SEVEN_OF_16, 2),
    (67, 16, _SEVEN_OF_16, 1),   # 67 x 2 > 132: the one-block layout
    (132, 16, _SEVEN_OF_16, 1),
    (500, 16, _SEVEN_OF_16, 1),
    (8, 16, {16: 7, 8: 7, 4: 7, 2: 7}, 1),  # nothing holds 8 clusters at once
    (1, 16, {}, 1),
    (1, 4, _SEVEN_OF_16, 4),     # G divides H
    (1, 12, _SEVEN_OF_16, 4),
    (1, 1, _SEVEN_OF_16, 1),
])
def test_cluster_size_rule(batch, heads, max_active, expected):
    """``cluster_size`` picks the largest power of two G <= 16 that divides
    H, keeps B x G within the SM count and lets all B clusters be resident
    (``max_active``); else 1. At the default and flagship widths (16 heads,
    132 SMs): 16 at B=1, 8 or 16 at B=8 as the card holds them, 1 from 67
    sequences on."""
    from composer_tpu_torch.ops import decode_kernel_batched as dkb

    assert dkb.cluster_size(batch, heads, 132, max_active) == expected
    assert dkb.CLUSTER_SIZES == (16, 8, 4, 2)


def _rows(rng, n=3, vocab=390, vpad=512):
    x = rng.normal(0.0, 3.0, (n, vpad)).astype(np.float32)
    x[:, vocab:] = dk.NEG_INF  # padding lanes, as the kernel's logits_b makes them
    return x


def _boundary(x, p):
    """Tokens whose strict mass-before lies within 1e-4 of p: there the
    masses, summed in different orders, may legitimately disagree."""
    xf = x.astype(np.float64)
    e = np.exp(xf - xf.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    mass_before = (probs[:, None, :] * (xf[:, None, :] > xf[:, :, None])).sum(-1)
    return np.abs(mass_before - p) < 1e-4


@pytest.mark.parametrize("top_k,top_p", [(1, 0.0), (5, 0.0), (40, 0.0), (390, 0.0),
                                         (512, 0.0), (0, 0.1), (0, 0.5), (0, 0.9),
                                         (0, 0.99), (20, 0.8)])
def test_filter_mask_matches_jax_kernel_filter(rng, top_k, top_p):
    x = _rows(rng)
    expected = np.asarray(jdk._filtered_scaled_logits(jnp.asarray(x), top_k, top_p)) > -5e29
    ours = dk.filtered_scaled_logits(torch.as_tensor(x), top_k, top_p).numpy() > -5e29
    disagree = ours != expected
    assert not (disagree & ~_boundary(x, top_p)).any()


def test_per_row_filter_thresholds_match_jax(rng):
    x = _rows(rng, n=4)
    ks = [1.0, 513.0, 40.0, 5.0]  # 513 = Vpad+1 sentinel (off)
    ps = [2.0, 0.5, 2.0, 0.9]  # 2.0 sentinel (off)
    expected = np.asarray(jdk._filtered_scaled_logits(
        jnp.asarray(x), [jnp.float32(k) for k in ks], [jnp.float32(p) for p in ps]
    )) > -5e29
    ours = dk.filtered_scaled_logits(torch.as_tensor(x), torch.tensor(ks),
                                     torch.tensor(ps)).numpy() > -5e29
    boundary = np.stack([_boundary(x[i:i + 1], p)[0] if p < 1 else np.zeros(512, bool)
                         for i, p in enumerate(ps)])
    assert not ((ours != expected) & ~boundary).any()


@pytest.mark.parametrize("k", [0, 1, 7, 390])
def test_unfused_top_k_rows_matches_jax(rng, k):
    x = rng.normal(0.0, 2.0, (3, 390)).astype(np.float32)
    x[0, :5] = x[0, 5]  # ties at the threshold are kept
    ks = np.array([k, max(k - 1, 0), 0], np.int32)
    expected = np.isfinite(np.asarray(jsampling.filter_top_k_rows(jnp.asarray(x), ks)))
    ours = torch.isfinite(sampling.filter_top_k_rows(torch.as_tensor(x), ks)).numpy()
    np.testing.assert_array_equal(ours, expected)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.0, 1.5])
def test_unfused_top_p_rows_matches_jax(rng, p):
    x = rng.normal(0.0, 2.0, (3, 390)).astype(np.float32)
    ps = np.array([p, 0.3, 0.0], np.float32)
    expected = np.isfinite(np.asarray(jsampling.filter_top_p_rows(jnp.asarray(x), ps)))
    ours = torch.isfinite(sampling.filter_top_p_rows(torch.as_tensor(x), ps)).numpy()
    boundary = np.stack([_boundary(x[i:i + 1], q)[0] for i, q in enumerate(ps)])
    assert not ((ours != expected) & ~boundary).any()


def test_philox_matches_known_answer():
    """Philox4x32-10 known-answer vector (Random123 kat_vectors): counter
    0, key 0 -> 6627e8d5 e169c58d bc57ac4c 9b00dbd8."""
    bits = dk.philox_bits(0, 1, 0, 4)
    assert [int(b) for b in bits[0]] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    noise = dk.gumbel_noise(7, 3, 11, 512)
    assert noise.dtype == torch.float32 and torch.isfinite(noise).all()
    assert not torch.equal(noise[0], noise[1])  # rows draw distinct bits


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(1.0, 0, 0.0), (0.7, 20, 0.0), (1.3, 0, 0.8), (1.0, 30, 0.9)])
def test_gumbel_max_sampling_matches_filtered_softmax(temperature, top_k, top_p):
    """Draw frequencies of the kernel's sampling step (Philox Gumbel-max,
    one draw per row of a large batch) against the kernel-definition
    filtered softmax: a chi-square test at a fixed seed."""
    rng = np.random.default_rng(11)
    logits = _rows(rng, n=1)[0] / 2
    draws = 20000
    x = torch.as_tensor(np.tile(logits, (draws, 1)))
    ids = dk.sample_rows(
        x, torch.full((draws,), temperature), torch.full((draws,), float(top_k or 513)),
        torch.full((draws,), top_p or 2.0), seed=1234, step=3,
    ).numpy()
    scaled = torch.as_tensor(logits[None] / np.float32(temperature))
    kept = dk.filtered_scaled_logits(scaled, top_k or None, top_p or None)[0].numpy() > -5e29
    z = scaled[0].double().numpy()
    probs = np.where(kept, np.exp(z - z[kept].max()), 0.0)
    probs /= probs.sum()
    assert set(ids.tolist()) <= set(np.flatnonzero(kept).tolist())
    counts = np.bincount(ids, minlength=512).astype(np.float64)
    expected = probs * draws
    big = expected >= 5
    observed = np.append(counts[big], counts[~big].sum())
    wanted = np.append(expected[big], expected[~big].sum())
    if wanted[-1] < 5:  # fold a thin tail into the last bin
        observed, wanted = observed[:-1], wanted[:-1]
        observed[-1] += counts[~big].sum()
        wanted[-1] += expected[~big].sum()
    assert stats.chisquare(observed, wanted).pvalue > 1e-3


def test_greedy_rows_inside_sampled_batch(setup):
    """A row with temperature 0 inside a sampled, filtered batch decodes
    exactly as in an all-greedy batch."""
    _, _, config, _, state = setup
    packed = dk.pack_weights(state, config, dtype=torch.float32)
    greedy = megakernel_generate_batched(packed, PROMPTS, 0, 0.0, config=config,
                                         length=8, cache_len=128)
    mixed = megakernel_generate_batched(
        packed, PROMPTS, 9, np.array([1.0, 0.0, 0.8], np.float32), config=config,
        length=8, cache_len=128, top_k=np.array([5, 3, 0]),
        top_p=np.array([0.0, 0.9, 0.7], np.float32),
    )
    np.testing.assert_array_equal(mixed[1].numpy(), greedy[1].numpy())
    again = megakernel_generate_batched(
        packed, PROMPTS, 9, np.array([1.0, 0.0, 0.8], np.float32), config=config,
        length=8, cache_len=128, top_k=np.array([5, 3, 0]),
        top_p=np.array([0.0, 0.9, 0.7], np.float32),
    )
    np.testing.assert_array_equal(again.numpy(), mixed.numpy())  # seeded: reproducible
