"""The port's streamed-weight segmented decode
(``ops/decode_kernel_wide_segmented.py``) against the JAX package's
``decode_segment_wide`` in Pallas interpret mode, JAX
``megakernel_generate_wide`` and the port's ``decode_wide`` and
``decode_segment`` plain versions (CPU, float32).

On the CPU the wrapper runs its plain PyTorch version. Greedy ids must equal
JAX's exactly. JAX runs with a test-sized tail window (16) and K/V chunk
(32), so its tail flushes at segment boundaries and its multi-chunk streaming
happen at these lengths. The contracts of ``tests/test_decode_wide_segmented.py``
are held for the port: any segmentation equals one whole generation, a row
admitted mid-flight equals a fresh run and leaves the rows in flight
unchanged, a reused slot decodes as a fresh one, parked slots emit -1 and
write nothing, generation past JAX's tail boundaries agrees, and a row that
lingers past ``live`` cannot corrupt its neighbour. Sampled streams are the
port's own property (the JAX kernel draws from the TPU PRNG): Philox keyed
by (seed, slot, global step) gives ``decode_segment``'s samples, under any
segmentation and any admission timing of other rows.

Each JAX interpret call (a compile of a few seconds) runs once, through the
module-scoped ``jax_runs``; the other contracts are held against the port's
own plain runs. Weights come from a numpy seed through ``params_from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composer_tpu.models.transformer import TransformerConfig as JaxConfig
from composer_tpu.ops import decode_kernel_wide as jax_wide
from composer_tpu.ops import decode_kernel_wide_segmented as jax_dws
from composer_tpu_torch.models.convert import params_from_flax
from composer_tpu_torch.models.transformer import TransformerConfig
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops import decode_kernel_segmented as seg
from composer_tpu_torch.ops import decode_kernel_wide as dw
from composer_tpu_torch.ops import decode_kernel_wide_segmented as dws

VOCAB = 61
CACHE = 128
TAIL, KV_CHUNK = 16, 32  # JAX's, test-sized as in tests/test_decode_wide_segmented.py
GREEDY = (0.0, 0, 0.0)
PROMPTS = np.random.default_rng(0).integers(0, VOCAB, (3, 6)).astype(np.int32)
PLENS = np.array([4, 2, 6], np.int32)
_MODELS = {}


def _numpy_params(config, seed: int) -> dict:
    """A Flax-layout parameter tree from a numpy seed (std 0.3, so greedy
    ids vary)."""
    rng = np.random.default_rng(seed)
    E, H, D = config.embed_dim, config.num_heads, config.head_dim

    def normal(*shape, std=0.3):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def norm():
        return {"scale": 1 + normal(E, std=0.1), "bias": normal(E, std=0.1)}

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out), "bias": normal(n_out, std=0.02)}

    params = {"wte": normal(config.vocab_size, E), "wpe": normal(config.window_size, E),
              "ln_f": norm()}
    for layer in range(config.num_layers):
        attn = {"c_attn": dense(E, 3 * E), "c_proj": dense(E, E)}
        if config.use_relative_attention:
            attn["rel_embedding"] = normal(H, config.window_size, D)
        params[f"h_{layer + 1}"] = {"ln_1": norm(), "ln_2": norm(), "attn": attn,
                                    "mlp": {"c_fc": dense(E, 4 * E), "c_proj": dense(4 * E, E)}}
    return params


def _setup(use_relative: bool):
    """(jax config, jax f32 wide packing, port config, port f32 wide packing,
    port state_dict): 1 layer without relative attention, 2 with."""
    if use_relative not in _MODELS:
        kwargs = dict(vocab_size=VOCAB, embed_dim=32, window_size=64,
                      num_layers=2 if use_relative else 1, num_heads=2,
                      use_relative_attention=use_relative, attention_dropout_rate=0.0,
                      residual_dropout_rate=0.0)
        jax_config = JaxConfig(**kwargs, dtype=jnp.float32, param_dtype=jnp.float32)
        config = TransformerConfig(**kwargs)
        tree = _numpy_params(config, seed=1 + use_relative)
        state = params_from_flax(tree, config)
        jax_packed = jax_wide.pack_weights_wide(jax.tree_util.tree_map(jnp.asarray, tree),
                                                jax_config, dtype=jnp.float32)
        packed = dw.pack_weights_wide(state, config, dtype=torch.float32)
        _MODELS[use_relative] = (jax_config, jax_packed, config, packed, state)
    return _MODELS[use_relative]


def _segments(packed, config, prompts, plens, starts, boundaries, sampling=GREEDY, seed=0,
              live=CACHE, state=None):
    """The port over consecutive [b0, b1) segments: ((B, steps) stream,
    (kv_state, carry))."""
    state = state or dws.init_wide_segment_state(packed, config, len(prompts), CACHE)
    chunks = []
    for b0, b1 in zip(boundaries[:-1], boundaries[1:]):
        tokens, *state = dws.decode_segment_wide(
            packed, *state, prompts, plens, starts, b0, seed, *sampling, config=config,
            steps=b1 - b0, cache_len=CACHE, live=live)
        chunks.append(tokens.numpy())
    return np.concatenate(chunks, axis=1), state


def _jax_segments(setup, calls, batch):
    """JAX over consecutive segments ``(prompts, plens, starts, b0, b1)`` on
    one state: the (B, steps) stream."""
    jax_config, jax_packed = setup[:2]
    kv, carry = jax_dws.init_wide_segment_state(jax_packed, jax_config, batch, CACHE,
                                                tail=TAIL, kv_chunk=KV_CHUNK)
    chunks = []
    for prompts, plens, starts, b0, b1 in calls:
        tokens, kv, carry = jax_dws.decode_segment_wide(
            jax_packed, kv, carry, prompts, plens, starts, b0, 0, 0.0, 0, 0.0,
            config=jax_config, steps=b1 - b0, cache_len=CACHE, live=CACHE, interpret=True,
            greedy=True, tail=TAIL, kv_chunk=KV_CHUNK)
        chunks.append(np.asarray(tokens))
    return np.concatenate(chunks, axis=1)


def _whole(packed, config, prompts, plens, length, **sampling):
    """One ``decode_wide`` plain run: (B, length) generated ids."""
    kv = dw.init_kv_state(config, len(prompts), CACHE, packed["wte"].dtype)
    tokens, _ = dw.megakernel_generate_wide(packed, kv, prompts, sampling.pop("seed", 0),
                                            sampling.pop("temperature", 0.0), config=config,
                                            length=length, cache_len=CACHE,
                                            prompt_lengths=plens, **sampling)
    return tokens.numpy()


def _gather(stream, start, plen, length):
    """A row's generation: its samples at steps start+plen-1 on."""
    first = start + plen - 1
    return stream[first:first + length]


# The admission scenario of tests/test_decode_wide_segmented.py: rows 0-1
# start at step 0, slot 2 is parked, then admitted at step 5 with a 5-event
# prompt and run 13 more steps.
_LATE = np.random.default_rng(1).integers(0, VOCAB, 5).astype(np.int32)


def _admission_calls():
    rng = np.random.default_rng(2)
    prompts = np.zeros((3, 6), np.int32)
    prompts[0, :4] = rng.integers(0, VOCAB, 4)
    prompts[1, :3] = rng.integers(0, VOCAB, 3)
    plens = np.array([4, 3, 1], np.int32)
    starts = np.array([0, 0, dws.PARKED], np.int32)
    first = (prompts.copy(), plens.copy(), starts.copy(), 0, 5)
    prompts[2, :5] = _LATE
    plens[2], starts[2] = 5, 5
    return [first, (prompts, plens, starts, 5, 18)]


# Slot reuse: slot 0's first occupant (4 + 10 events) finishes inside the
# first 13-step segment; a second request (3 events) takes the same slot at
# step 13. Slot 1 stays parked.
_FIRST, _SECOND = (np.random.default_rng(3).integers(0, VOCAB, n).astype(np.int32)
                   for n in (4, 3))


def _reuse_calls():
    prompts = np.zeros((2, 4), np.int32)
    prompts[0] = _FIRST
    first = (prompts.copy(), np.array([4, 1], np.int32), np.array([0, dws.PARKED], np.int32),
             0, 13)
    prompts[0] = 0
    prompts[0, :3] = _SECOND
    return [first, (prompts, np.array([3, 1], np.int32), np.array([13, dws.PARKED], np.int32),
                    13, 26)]


# Across JAX's tail flushes: 48 generated events cross two 16-row windows;
# the boundaries at 13, 26 and 39 cut mid-window.
_TAIL_PROMPTS = np.random.default_rng(4).integers(0, VOCAB, (2, 5)).astype(np.int32)
_TAIL_PLENS = np.array([3, 5], np.int32)
_TAIL_BOUNDARIES = [0, 13, 26, 39, 52]


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX interpret run, computed at its first use and kept."""
    done = {}

    def run(name):
        if name not in done:
            starts3 = np.zeros(3, np.int32)
            if name.startswith("cut"):
                setup = _setup(name == "cut_rel")
                done[name] = _jax_segments(setup, [(PROMPTS, PLENS, starts3, b0, b1) for b0, b1
                                                   in ((0, 5), (5, 10), (10, 13))], 3)
            elif name.startswith("whole"):
                jax_config, jax_packed = _setup(name == "whole_rel")[:2]
                kv = jax_wide.init_kv_state(jax_config, 3, CACHE, dtype=jnp.float32)
                tokens, _ = jax_wide.megakernel_generate_wide(
                    jax_packed, kv, PROMPTS, 0, 0.0, config=jax_config, length=8,
                    cache_len=CACHE, interpret=True, prompt_lengths=PLENS)
                done[name] = np.asarray(tokens)
            elif name == "tail":
                starts2 = np.zeros(2, np.int32)
                done[name] = _jax_segments(_setup(False), [
                    (_TAIL_PROMPTS, _TAIL_PLENS, starts2, b0, b1)
                    for b0, b1 in zip(_TAIL_BOUNDARIES[:-1], _TAIL_BOUNDARIES[1:])], 2)
            elif name == "admission":
                done[name] = _jax_segments(_setup(True), _admission_calls(), 3)
            elif name == "reuse":
                done[name] = _jax_segments(_setup(False), _reuse_calls(), 2)
        return done[name]

    return run


@pytest.mark.parametrize("use_relative", [False, True])
def test_any_segmentation_matches_jax_and_whole_generation(jax_runs, use_relative):
    """The whole stream, prompt steps included, equals JAX's for the same
    cut; every cut gives the same stream; each row's generation equals one
    ``decode_wide`` plain run and JAX's whole generation."""
    _, _, config, packed, _ = _setup(use_relative)
    starts = np.zeros(3, np.int32)
    stream, _ = _segments(packed, config, PROMPTS, PLENS, starts, [0, 5, 10, 13])
    np.testing.assert_array_equal(stream, jax_runs("cut_rel" if use_relative else "cut"))
    for boundaries in ([0, 13], list(range(14))):
        other, _ = _segments(packed, config, PROMPTS, PLENS, starts, boundaries)
        np.testing.assert_array_equal(other, stream, err_msg=f"boundaries {boundaries}")
    whole = _whole(packed, config, PROMPTS, PLENS, 8)
    np.testing.assert_array_equal(whole, jax_runs("whole_rel" if use_relative else "whole"))
    for row in range(3):
        np.testing.assert_array_equal(_gather(stream[row], 0, int(PLENS[row]), 8), whole[row],
                                      err_msg=f"row {row}")
    assert len(set(stream.ravel().tolist())) > 3


def test_generation_across_jax_tail_flushes(jax_runs):
    """52 steps cross JAX's 16-row tail window twice, with segment
    boundaries mid-window: the streams agree, and equal the uncut run and
    one whole generation."""
    _, _, config, packed, _ = _setup(False)
    starts = np.zeros(2, np.int32)
    stream, _ = _segments(packed, config, _TAIL_PROMPTS, _TAIL_PLENS, starts, _TAIL_BOUNDARIES)
    np.testing.assert_array_equal(stream, jax_runs("tail"))
    uncut, _ = _segments(packed, config, _TAIL_PROMPTS, _TAIL_PLENS, starts, [0, 52])
    np.testing.assert_array_equal(uncut, stream)
    whole = _whole(packed, config, _TAIL_PROMPTS, _TAIL_PLENS, 48)
    for row in range(2):
        np.testing.assert_array_equal(_gather(stream[row], 0, int(_TAIL_PLENS[row]), 48),
                                      whole[row])


def _port_calls(setup, calls, batch):
    """The port over the same calls as ``_jax_segments``, on one state."""
    _, _, config, packed, _ = setup
    state = dws.init_wide_segment_state(packed, config, batch, CACHE)
    chunks = []
    for prompts, plens, starts, b0, b1 in calls:
        stream, state = _segments(packed, config, prompts, plens, starts, [b0, b1], state=state)
        chunks.append(stream)
    return np.concatenate(chunks, axis=1)


def test_admission_mid_flight_matches_fresh_run(jax_runs):
    """A row admitted at a segment boundary decodes exactly a fresh run, the
    rows in flight are unchanged, and the stream equals JAX's."""
    setup = _setup(True)
    _, _, config, packed, _ = setup
    calls = _admission_calls()
    stream = _port_calls(setup, calls, 3)
    np.testing.assert_array_equal(stream, jax_runs("admission"))
    assert (stream[2, :5] == -1).all() and (stream[:, 5:] >= 0).all()
    prompts, plens = calls[1][0], calls[1][1]
    alone = _whole(packed, config, prompts[:2], plens[:2], 8)
    for row in range(2):
        np.testing.assert_array_equal(_gather(stream[row], 0, int(plens[row]), 8), alone[row])
    fresh = _whole(packed, config, _LATE[None], np.array([5], np.int32), 9)
    np.testing.assert_array_equal(_gather(stream[2], 5, 5, 9), fresh[0])


def test_reused_slot_decodes_as_fresh(jax_runs):
    """An evicted slot's next occupant reads only rows it wrote: it decodes
    as a fresh run, as in JAX; the slot parked throughout emits -1."""
    setup = _setup(False)
    _, _, config, packed, _ = setup
    stream = _port_calls(setup, _reuse_calls(), 2)
    np.testing.assert_array_equal(stream, jax_runs("reuse"))
    assert (stream[1] == -1).all()
    np.testing.assert_array_equal(_gather(stream[0], 0, 4, 10),
                                  _whole(packed, config, _FIRST[None], np.array([4]), 10)[0])
    np.testing.assert_array_equal(_gather(stream[0], 13, 3, 10),
                                  _whole(packed, config, _SECOND[None], np.array([3]), 10)[0])


def test_parked_slots_emit_minus_one_and_write_nothing():
    """A parked slot (and a slot whose start lies inside the segment, until
    it arrives) emits -1 and leaves its cache rows as they were; a slot
    parked through the segment carries its prompt's first token."""
    _, _, config, packed, _ = _setup(True)
    kv, carry = dws.init_wide_segment_state(packed, config, 3, CACHE)
    kv.copy_(torch.randn(kv.shape, generator=torch.Generator().manual_seed(0)))
    before = kv.clone()
    starts = np.array([0, dws.PARKED, 6], np.int32)
    tokens, kv, carry = dws.decode_segment_wide(
        packed, kv, carry, PROMPTS, PLENS, starts, 0, 0, *GREEDY, config=config, steps=10,
        cache_len=CACHE, live=CACHE)
    tokens = tokens.numpy()
    assert (tokens[1] == -1).all() and (tokens[2, :6] == -1).all()
    assert (tokens[0] >= 0).all() and (tokens[2, 6:] >= 0).all()
    assert torch.equal(kv[:, :, 1], before[:, :, 1])
    assert torch.equal(kv[:, :, 2, 4:], before[:, :, 2, 4:])  # positions 0-3 written, no more
    assert not torch.equal(kv[:, :, 2, :4], before[:, :, 2, :4])
    assert int(carry[1]) == PROMPTS[1, 0]


@pytest.mark.parametrize("live,first_len", [(32, 32), (CACHE, CACHE - 8)])
def test_lingering_row_cannot_corrupt_neighbour(live, first_len):
    """A finished row not yet evicted runs on past ``live``: it attends to
    [0, live) and writes nothing (in the second case its positions pass
    ``cache_len``). The row admitted into the next slot decodes exactly its
    fresh run."""
    _, _, config, packed, _ = _setup(True)
    rng = np.random.default_rng(5)
    prompts = np.zeros((2, 6), np.int32)
    prompts[0, :4] = rng.integers(0, VOCAB, 4)
    late = rng.integers(0, VOCAB, 6).astype(np.int32)
    plens = np.array([4, 1], np.int32)
    starts = np.array([0, dws.PARKED], np.int32)
    _, state = _segments(packed, config, prompts, plens, starts, [0, first_len], live=live)
    prompts[1] = late
    plens[1], starts[1] = 6, first_len
    stream, _ = _segments(packed, config, prompts, plens, starts, [first_len, first_len + 16],
                          live=live, state=state)
    np.testing.assert_array_equal(_gather(stream[1], 0, 6, 11),
                                  _whole(packed, config, late[None], np.array([6]), 11)[0])
    assert (stream[0] >= 0).all()  # the lingering row still emits (discarded) samples


SAMPLED = dict(seed=9, sampling=(np.array([1.0, 0.8, 0.0], np.float32), np.array([0, 10, 0]),
                                 np.array([0.9, 0.0, 0.0], np.float32)))


def test_sampled_streams_equal_decode_segment_under_any_cut():
    """Per-row temperature, top-k, top-p and a greedy row: ids and carry
    equal ``decode_segment``'s plain version on the same weights, under
    segments of 1, 7 and 64; row 0's stream does not depend on when row 1
    is admitted, or whether it is."""
    _, _, config, packed, state_dict = _setup(True)
    resident = dk.pack_weights(state_dict, config, dtype=torch.float32)
    prompts = np.random.default_rng(6).integers(0, VOCAB, (3, 6)).astype(np.int32)
    plens = np.array([6, 3, 4], np.int32)
    starts = np.array([0, 0, 3], np.int32)
    steps = 70
    kcache, vcache, carry = seg.init_segment_state(resident, config, 3, CACHE)
    expected, *_ = seg.decode_segment(resident, kcache, vcache, carry, prompts, plens, starts,
                                      0, SAMPLED["seed"], *SAMPLED["sampling"], config=config,
                                      steps=steps, cache_len=CACHE, live=CACHE)
    for length in (1, 7, 64):
        boundaries = list(range(0, steps, length)) + [steps]
        stream, (_, ours) = _segments(packed, config, prompts, plens, starts, boundaries,
                                      **SAMPLED)
        np.testing.assert_array_equal(stream, expected.numpy(), err_msg=f"segments of {length}")
        np.testing.assert_array_equal(ours.numpy(), carry.numpy())
    assert len(set(stream[0].tolist())) > 5 and (stream[2, :3] == -1).all()

    row0 = []
    for start1 in (dws.PARKED, 4, 11):
        stream, _ = _segments(packed, config, prompts, plens,
                              np.array([0, start1, dws.PARKED], np.int32), [0, 7, 14, 30],
                              **SAMPLED)
        row0.append(stream[0])
    for other in row0[1:]:
        np.testing.assert_array_equal(other, row0[0])
    np.testing.assert_array_equal(row0[0], expected.numpy()[0, :30])


def test_int8_weights_equal_decode_wide():
    """int8 weights (bf16 tables and activations): with every slot starting
    at step 0, the greedy ids equal ``decode_wide``'s plain version on the
    same packing."""
    _, _, config, _, state_dict = _setup(True)
    packed = dw.pack_weights_wide(state_dict, config, dtype=torch.int8)
    kv, _ = dws.init_wide_segment_state(packed, config, 3, CACHE)
    assert kv.dtype == torch.bfloat16 and kv.shape == (2, 2, 3, CACHE, 32)
    stream, _ = _segments(packed, config, PROMPTS, PLENS, np.zeros(3, np.int32),
                          [0, 7, 14, 21])
    whole = _whole(packed, config, PROMPTS, PLENS, 16)
    for row in range(3):
        np.testing.assert_array_equal(_gather(stream[row], 0, int(PLENS[row]), 16), whole[row])


def test_kernel_limits_and_inputs():
    """``wide_segment_kernel_fits``: the flagship's 8 slots fit at live 2048,
    9 slots never, nor widths ``decode_wide`` does not take; mismatched state
    is refused."""
    flagship = TransformerConfig(vocab_size=390, embed_dim=1024, window_size=2048,
                                 num_layers=8, num_heads=16, use_relative_attention=True)
    assert dws.wide_segment_kernel_fits(flagship, 8, 2048)
    assert dws.wide_segment_smem_bytes(flagship, 8, 2048) == (
        dws.STEP_INFO_BYTES + 4 * (64 + 1024) + 4 * 8 * 1024 * 2 + 2 * dw.STAGE_BYTES)
    assert not dws.wide_segment_kernel_fits(flagship, 9, 256)
    assert not dws.wide_segment_kernel_fits(
        TransformerConfig(vocab_size=390, embed_dim=1000, num_heads=8), 2, 256)
    _, _, config, packed, _ = _setup(False)
    kv, carry = dws.init_wide_segment_state(packed, config, 2, CACHE)
    with pytest.raises(ValueError, match="kv_state"):
        dws.decode_segment_wide(packed, kv, carry, PROMPTS, PLENS, np.zeros(3, np.int32), 0, 0,
                                *GREEDY, config=config, steps=4, cache_len=CACHE, live=CACHE)
    with pytest.raises(ValueError, match="prompt lengths"):
        dws.decode_segment_wide(packed, kv, carry, PROMPTS[:2], np.array([0, 3]),
                                np.zeros(2, np.int32), 0, 0, *GREEDY, config=config, steps=4,
                                cache_len=CACHE, live=CACHE)
