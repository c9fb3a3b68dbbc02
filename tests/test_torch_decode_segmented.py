"""The port's segmented decode (``ops/decode_kernel_segmented.py``) against the
JAX package's ``decode_segment`` in Pallas interpret mode, JAX
``generate_ids(engine="xla")`` and the port's ``decode_generate`` plain
version (CPU, float32).

On the CPU the wrapper runs its plain PyTorch version. Greedy ids must be
equal exactly. The contracts of ``tests/test_decode_segmented.py`` are held
here for the port: any segmentation equals the uncut run, a row admitted
mid-flight equals a fresh run and leaves the rows in flight unchanged,
parked slots emit -1 and write nothing, a staged ``live`` equals the full
cache, and a row that lingers past ``live`` cannot corrupt its neighbour.
Sampled streams are the port's own property (the JAX kernel draws from the
TPU PRNG): Philox keyed by (seed, slot, global step) makes them identical
under any segmentation and any admission timing of other rows.
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
from composer_tpu.ops import decode_kernel_segmented as jax_seg
from composer_tpu.train.generate import generate_ids as jax_generate_ids
from composer_tpu_torch.models.convert import params_from_flax
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops import decode_kernel_segmented as seg
from composer_tpu_torch.ops.decode_kernel_batched import megakernel_generate_batched

CACHE = 128
_MODELS = {}


def _setup(use_relative=False, num_layers=1):
    """A small f32 model (vocab 96, embed 32, 2 heads, window 48) in both
    packages: (jax model, jax params, port model, port f32 packed)."""
    key = (use_relative, num_layers)
    if key not in _MODELS:
        kwargs = dict(vocab_size=96, embed_dim=32, window_size=48, num_layers=num_layers,
                      num_heads=2, use_relative_attention=use_relative,
                      attention_dropout_rate=0.0, residual_dropout_rate=0.0,
                      initializer_stddev=0.3)
        jax_model = JaxTransformer(JaxConfig(**kwargs, dtype=jnp.float32,
                                             param_dtype=jnp.float32))
        params = jax_model.init_params(jax.random.PRNGKey(0), 1, 8)
        model = Transformer(TransformerConfig(**kwargs), device="cpu")
        model.load_state_dict(params_from_flax(jax.device_get(params), model.config))
        packed = dk.pack_weights(model.state_dict(), model.config, dtype=torch.float32)
        _MODELS[key] = (jax_model, params, model.eval(), packed)
    return _MODELS[key]


def _run(packed, config, prompts, plens, starts, boundaries, seed=0, temperature=0.0,
         top_k=0, top_p=0.0, live=CACHE, state=None):
    """decode_segment over consecutive [b0, b1) ranges; returns the (B, steps)
    token stream and the final (kcache, vcache, carry)."""
    state = state or seg.init_segment_state(packed, config, prompts.shape[0], CACHE)
    chunks = []
    for b0, b1 in zip(boundaries[:-1], boundaries[1:]):
        tokens, *state = seg.decode_segment(
            packed, *state, prompts, plens, starts, b0, seed, temperature, top_k, top_p,
            config=config, steps=b1 - b0, cache_len=CACHE, live=live)
        chunks.append(tokens.numpy())
    return np.concatenate(chunks, axis=1), state


def _gather(stream, start, plen, length):
    """A row's generation: its samples at steps start+plen-1 on."""
    first = start + plen - 1
    return stream[first:first + length]


def _jax_segments(setup, prompts, plens, starts, boundaries):
    jax_model, params, _, _ = setup
    packed = jax_dk.pack_weights(params, jax_model.config, dtype=jnp.float32)
    kbuf, vbuf, carry = jax_seg.init_segment_state(packed, jax_model.config,
                                                   prompts.shape[0], CACHE)
    chunks = []
    for b0, b1 in zip(boundaries[:-1], boundaries[1:]):
        tokens, kbuf, vbuf, carry = jax_seg.decode_segment(
            packed, kbuf, vbuf, carry, prompts, plens, starts, b0, 0, 0.0, 0, 0.0,
            config=jax_model.config, steps=b1 - b0, cache_len=CACHE, live=CACHE,
            interpret=True, greedy=True)
        chunks.append(np.asarray(tokens))
    return np.concatenate(chunks, axis=1)


def _xla(setup, prompts, plens, length):
    jax_model, params, _, _ = setup
    out = jax_generate_ids(jax_model, JaxModelType.TRANSFORMER, params, prompts,
                           length=length, temperature=0.0, seed=0, engine="xla",
                           prompt_lengths=plens)
    return np.asarray(out)[:, prompts.shape[1]:]


PROMPTS = np.random.default_rng(0).integers(0, 96, (3, 6)).astype(np.int32)
PLENS = np.array([4, 2, 6], np.int32)


@pytest.mark.parametrize("use_relative,boundaries", [
    (False, [0, 3, 7, 13]),
    (True, [0, 13]),
])
def test_greedy_matches_jax_segment_kernel(use_relative, boundaries):
    """The whole stream, parked and prompt steps included, equals the JAX
    kernel's for the same segmentation."""
    setup = _setup(use_relative)
    starts = np.array([0, 0, 2], np.int32)
    expected = _jax_segments(setup, PROMPTS, PLENS, starts, boundaries)
    _, _, model, packed = setup
    stream, _ = _run(packed, model.config, PROMPTS, PLENS, starts, boundaries)
    np.testing.assert_array_equal(stream, expected)
    assert (stream[2, :2] == -1).all() and (stream[:, 2:] >= 0).all()


@pytest.mark.parametrize("use_relative", [False, True])
def test_any_segmentation_matches_xla_and_decode_generate(use_relative):
    setup = _setup(use_relative, num_layers=2)
    _, _, model, packed = setup
    length = 12
    total = int(PLENS.max()) + length - 1
    xla = _xla(setup, PROMPTS, PLENS, length)
    fused = megakernel_generate_batched(packed, PROMPTS, 0, 0.0, config=model.config,
                                        length=length, cache_len=CACHE,
                                        prompt_lengths=PLENS).numpy()
    np.testing.assert_array_equal(fused, xla)
    starts = np.zeros(3, np.int32)
    for boundaries in ([0, total], [0, 3, 7, total], list(range(total + 1))):
        stream, _ = _run(packed, model.config, PROMPTS, PLENS, starts, boundaries)
        for row in range(3):
            np.testing.assert_array_equal(
                _gather(stream[row], 0, int(PLENS[row]), length), xla[row],
                err_msg=f"row {row} boundaries {boundaries}")
    assert len(set(xla.ravel().tolist())) > 3


def _admission(setup, seg_len, runner):
    """Rows 0-1 start at step 0; slot 2 is parked, then admitted at step
    ``seg_len`` with a 5-event prompt. Returns the stream and the prompts."""
    rng = np.random.default_rng(1)
    prompts = np.zeros((3, 6), np.int32)
    prompts[0, :4] = rng.integers(0, 96, 4)
    prompts[1, :3] = rng.integers(0, 96, 3)
    late = rng.integers(0, 96, 5).astype(np.int32)
    plens = np.array([4, 3, 1], np.int32)
    starts = np.array([0, 0, seg.PARKED], np.int32)
    first = runner(prompts.copy(), plens.copy(), starts.copy(), 0, seg_len)
    prompts[2, :5] = late
    plens[2] = 5
    starts[2] = seg_len
    second = runner(prompts, plens, starts, seg_len, seg_len + 13)
    return np.concatenate([first, second], axis=1), prompts, plens, late


def test_admission_mid_flight_matches_fresh_run_and_jax():
    """A row admitted at a segment boundary decodes exactly a fresh run, the
    rows in flight are unchanged, and the stream equals the JAX kernel's."""
    setup = _setup(True)
    jax_model, params, model, packed = setup
    jpacked = jax_dk.pack_weights(params, jax_model.config, dtype=jnp.float32)
    jstate = list(jax_seg.init_segment_state(jpacked, jax_model.config, 3, CACHE))
    state = list(seg.init_segment_state(packed, model.config, 3, CACHE))

    def port(prompts, plens, starts, b0, b1):
        tokens, *state[:] = seg.decode_segment(
            packed, *state, prompts, plens, starts, b0, 0, 0.0, 0, 0.0,
            config=model.config, steps=b1 - b0, cache_len=CACHE, live=CACHE)
        return tokens.numpy()

    def reference(prompts, plens, starts, b0, b1):
        tokens, *jstate[:] = jax_seg.decode_segment(
            jpacked, *jstate, prompts, plens, starts, b0, 0, 0.0, 0, 0.0,
            config=jax_model.config, steps=b1 - b0, cache_len=CACHE, live=CACHE,
            interpret=True, greedy=True)
        return np.asarray(tokens)

    stream, prompts, plens, late = _admission(setup, 5, port)
    expected, *_ = _admission(setup, 5, reference)
    np.testing.assert_array_equal(stream, expected)
    assert (stream[2, :5] == -1).all()

    alone, _ = _run(packed, model.config, prompts[:2], plens[:2], np.zeros(2, np.int32),
                    [0, 18])
    for row in range(2):
        np.testing.assert_array_equal(_gather(stream[row], 0, int(plens[row]), 8),
                                      _gather(alone[row], 0, int(plens[row]), 8))
    fresh = dk.megakernel_generate(packed, late, 0, 0.0, config=model.config, length=9,
                                   cache_len=CACHE).numpy()
    np.testing.assert_array_equal(_gather(stream[2], 5, 5, 9), fresh)


def test_parked_slots_emit_minus_one_and_write_nothing():
    """A parked slot (and a slot whose start lies inside the segment, until
    it arrives) emits -1 and leaves its cache rows as they were; a slot
    parked through the segment carries its prompt's first token."""
    _, _, model, packed = _setup(True)
    config = model.config
    kcache, vcache, carry = seg.init_segment_state(packed, config, 3, CACHE)
    kcache.copy_(torch.randn(kcache.shape, generator=torch.Generator().manual_seed(0)))
    before = kcache.clone()
    starts = np.array([0, seg.PARKED, 6], np.int32)
    tokens, kcache, vcache, carry = seg.decode_segment(
        packed, kcache, vcache, carry, PROMPTS, PLENS, starts, 0, 0, 0.0, 0, 0.0,
        config=config, steps=10, cache_len=CACHE, live=CACHE)
    tokens = tokens.numpy()
    assert (tokens[1] == -1).all() and (tokens[2, :6] == -1).all()
    assert (tokens[0] >= 0).all() and (tokens[2, 6:] >= 0).all()
    rows = kcache.view(config.num_layers, 3, CACHE, -1)
    old = before.view(config.num_layers, 3, CACHE, -1)
    assert torch.equal(rows[:, 1], old[:, 1])
    assert torch.equal(rows[:, 2, 4:], old[:, 2, 4:])  # positions 0-3 written, no more
    assert not torch.equal(rows[:, 2, :4], old[:, 2, :4])
    assert int(carry[1]) == PROMPTS[1, 0]


def test_staged_live_matches_full_cache():
    """Reading only a ``live`` prefix that grows with the oldest row emits
    what reading the whole cache emits."""
    _, _, model, packed = _setup(True)
    prompts = np.random.default_rng(2).integers(0, 96, (2, 5)).astype(np.int32)
    plens = np.array([5, 3], np.int32)
    starts = np.zeros(2, np.int32)
    full, _ = _run(packed, model.config, prompts, plens, starts, [0, 24])
    state = None
    chunks = []
    for b0, b1 in [(0, 8), (8, 16), (16, 24)]:
        tokens, state = _run(packed, model.config, prompts, plens, starts, [b0, b1],
                             live=((b1 + 15) // 16) * 16, state=state)
        chunks.append(tokens)
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), full)


@pytest.mark.parametrize("live,first_len", [(32, 32), (CACHE, CACHE - 8)])
def test_lingering_row_cannot_corrupt_neighbour(live, first_len):
    """A finished row not yet evicted runs on past ``live``: it attends to
    [0, live) and writes nothing. In the second case its positions pass
    ``cache_len``, where a write would land in the next slot's rows. The row
    admitted into that next slot decodes exactly its fresh run."""
    _, _, model, packed = _setup(True)
    config = model.config
    rng = np.random.default_rng(3)
    prompts = np.zeros((2, 6), np.int32)
    prompts[0, :4] = rng.integers(0, 96, 4)
    late = rng.integers(0, 96, 6).astype(np.int32)
    plens = np.array([4, 1], np.int32)
    starts = np.array([0, seg.PARKED], np.int32)
    _, state = _run(packed, config, prompts, plens, starts, [0, first_len], live=live)
    prompts[1] = late
    plens[1] = 6
    starts[1] = first_len
    stream, state = _run(packed, config, prompts, plens, starts,
                         [first_len, first_len + 16], live=live, state=state)
    fresh = dk.megakernel_generate(packed, late, 0, 0.0, config=config, length=11,
                                   cache_len=CACHE).numpy()
    np.testing.assert_array_equal(_gather(stream[1], 0, 6, 11), fresh)
    assert (stream[0] >= 0).all()  # the lingering row still emits (discarded) samples


@pytest.mark.parametrize("use_relative", [False, True])
def test_generation_past_the_window_matches_xla(use_relative):
    """Positions past ``window_size`` take the last position embedding and no
    relative bias beyond the table, as the XLA engine does."""
    setup = _setup(use_relative)
    _, _, model, packed = setup
    prompt = np.array([[7, 30, 60, 45, 2]], np.int32)
    length = 70  # positions up to 74 > window 48
    expected = _xla(setup, prompt, None, length)[0]
    stream, _ = _run(packed, model.config, prompt, np.array([5], np.int32),
                     np.zeros(1, np.int32), [0, 32, 64, 74])
    np.testing.assert_array_equal(_gather(stream[0], 0, 5, length), expected)


def test_sampled_streams_ignore_segmentation_and_admission_timing():
    """Mixed per-row sampling (temperature, top-k, top-p, a greedy row):
    every segmentation gives the same stream, and row 0's stream does not
    depend on when row 1 is admitted, or whether it is."""
    _, _, model, packed = _setup(True)
    config = model.config
    prompts = np.random.default_rng(4).integers(0, 96, (3, 6)).astype(np.int32)
    plens = np.array([6, 3, 4], np.int32)
    sampling = dict(seed=9, temperature=np.array([1.0, 0.8, 0.0], np.float32),
                    top_k=np.array([0, 10, 0]), top_p=np.array([0.9, 0.0, 0.0], np.float32))
    starts = np.zeros(3, np.int32)
    whole, _ = _run(packed, config, prompts, plens, starts, [0, 30], **sampling)
    for boundaries in ([0, 1, 8, 30], [0, 7, 14, 21, 28, 30]):
        cut, _ = _run(packed, config, prompts, plens, starts, boundaries, **sampling)
        np.testing.assert_array_equal(cut, whole)
    assert len(set(whole[0].tolist())) > 5

    row0 = []
    for start1 in (seg.PARKED, 4, 11):
        starts = np.array([0, start1, seg.PARKED], np.int32)
        stream, _ = _run(packed, config, prompts, plens, starts, [0, 7, 14, 30], **sampling)
        row0.append(stream[0])
        if start1 != seg.PARKED:
            assert (stream[1, :start1] == -1).all() and (stream[1, start1:] >= 0).all()
    np.testing.assert_array_equal(row0[1], row0[0])
    np.testing.assert_array_equal(row0[2], row0[0])
    np.testing.assert_array_equal(row0[0], whole[0])


def test_kernel_limit_counts_the_scores_per_live_row():
    """``segment_kernel_fits`` bounds the rows attention reads: the default
    model fits 3067 of them, 8 slots at cache 2048 fit, head_dim must be a
    multiple of 8."""
    config = TransformerConfig(vocab_size=390)
    assert seg.segment_kernel_fits(config, 2048)
    assert seg.segment_kernel_fits(config, 3067) and not seg.segment_kernel_fits(config, 3068)
    assert not seg.segment_kernel_fits(TransformerConfig(vocab_size=390, embed_dim=48,
                                                         num_heads=4), 128)
