"""The port's wide decode (``ops/decode_kernel_wide.py``) against the JAX
package's ``megakernel_generate_wide`` in Pallas interpret mode, the port's
``decode_generate`` plain version and JAX ``generate_ids`` (CPU).

On the CPU the wrapper runs its plain PyTorch version. float32 greedy ids
must equal JAX's exactly; the packing and the K/V quantizer must match bit
for bit (scales to rtol 1e-6: they come out of one float32 division on both
sides, in an order XLA may change). The model is the JAX package's wide-test
size (vocab 61, embed 32, 2 layers, 4 heads), with weights scaled so greedy
ids vary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composer_tpu.models import ModelType as JaxModelType
from composer_tpu.models.transformer import Transformer as JaxTransformer
from composer_tpu.models.transformer import TransformerConfig as JaxConfig
from composer_tpu.ops import decode_kernel_wide as jax_wide
from composer_tpu.train.generate import generate_ids as jax_generate_ids
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.convert import params_from_flax
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops import decode_kernel_wide as dw
from composer_tpu_torch.ops import decode_kernel_wide_segmented as dws
from composer_tpu_torch.ops.decode_kernel_batched import megakernel_generate_batched
from composer_tpu_torch.train import generate as gen

VOCAB = 61
_MODELS = {}


def _setup(use_relative=True, window=64):
    """(jax model, jax params, port model) in float32."""
    key = (use_relative, window)
    if key not in _MODELS:
        kwargs = dict(vocab_size=VOCAB, embed_dim=32, window_size=window, num_layers=2,
                      num_heads=4, use_relative_attention=use_relative,
                      attention_dropout_rate=0.0, residual_dropout_rate=0.0,
                      initializer_stddev=0.3)
        jax_model = JaxTransformer(JaxConfig(**kwargs, dtype=jnp.float32,
                                             param_dtype=jnp.float32))
        params = jax_model.init_params(jax.random.PRNGKey(3), 1, 8)
        model = Transformer(TransformerConfig(**kwargs), device="cpu")
        model.load_state_dict(params_from_flax(jax.device_get(params), model.config))
        _MODELS[key] = (jax_model, params, model.eval())
    return _MODELS[key]


def _jax_ids(setup, prompts, length, cache_len, dtype=jnp.float32, quantize_kv=False, **kw):
    jax_model, params, _ = setup
    packed = jax_wide.pack_weights_wide(params, jax_model.config, dtype=dtype)
    kv = jax_wide.init_kv_state(jax_model.config, prompts.shape[0], cache_len,
                                dtype=jnp.bfloat16 if dtype == jnp.int8 else jnp.float32,
                                quantize_kv=quantize_kv)
    tokens, _ = jax_wide.megakernel_generate_wide(
        packed, kv, prompts, kw.pop("seed", 0), kw.pop("temperature", 0.0),
        config=jax_model.config, length=length, cache_len=cache_len, interpret=True, **kw)
    return np.asarray(tokens)


def _port_ids(setup, prompts, length, cache_len, dtype=torch.float32, quantize_kv=False,
              kv=None, **kw):
    model = setup[2]
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=dtype)
    if kv is None:
        kv = dw.init_kv_state(model.config, prompts.shape[0], cache_len, packed["wte"].dtype,
                              quantize_kv)
    tokens, _ = dw.megakernel_generate_wide(
        packed, kv, prompts, kw.pop("seed", 0), kw.pop("temperature", 0.0),
        config=model.config, length=length, cache_len=cache_len, **kw)
    return tokens.numpy()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pack_weights_wide_matches_jax(dtype):
    """The port stores the matmul blocks output-major: its big_w / fp_w /
    logits_w are the transposes of JAX's big_w / fp_w / wte_t."""
    jax_model, params, model = _setup()
    jax_packed = jax_wide.pack_weights_wide(params, jax_model.config, dtype=getattr(jnp, dtype))
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=getattr(torch, dtype))
    for name in ("big_w", "fp_w"):
        np.testing.assert_array_equal(packed[name].transpose(1, 2).numpy(),
                                      np.asarray(jax_packed[name]), err_msg=name)
    if dtype == "int8":
        for name in ("wscale", "fpscale"):
            np.testing.assert_allclose(packed[name].numpy(),
                                       np.asarray(jax_packed[name])[:, 0], rtol=1e-6)
        assert packed["wte"].dtype == torch.bfloat16 and "wscale" in packed
    else:
        assert "wscale" not in packed
    for name, theirs in (("wte", "wte"), ("wpe", "wpe"), ("logits_w", "wte_t")):
        ours = packed[name].float().numpy()
        np.testing.assert_array_equal(ours.T if name == "logits_w" else ours,
                                      np.asarray(jax_packed[theirs], np.float32), err_msg=name)


def test_quantize_kv_segments_matches_jax():
    rng = np.random.default_rng(0)
    block = (rng.standard_normal((16, 6 * 32)) * rng.uniform(0.01, 10, (16, 1))).astype(
        np.float32)
    block[3, 32:64] = 0.0  # an all-zero segment takes the 1e-12 guard
    q, scales = dw.quantize_kv_segments(torch.from_numpy(block), 6, 32)
    jq, jscales = jax_wide.quantize_kv_segments(jnp.asarray(block), 6, 32)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    assert q.dtype == torch.int8 and scales.shape == (16, 6)


@pytest.mark.parametrize("case", ["abs", "rel", "filtered", "ragged", "int8", "int8_kv"])
def test_plain_greedy_matches_jax(case):
    """Greedy float32 ids equal JAX's wide kernel in interpret mode: relative
    attention off and on, top-k / top-p at temperature 0, ragged prompts,
    int8 weights (bf16 activations, K/V bf16) and int8 K/V."""
    setup = _setup(use_relative=case != "abs")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, VOCAB, (3, 6)).astype(np.int32)
    kw = {}
    if case == "filtered":
        kw = dict(top_k=np.array([0, 2, 5], np.int32),
                  top_p=np.array([0.9, 0.0, 0.5], np.float32), seed=7)
    if case == "ragged":
        kw = dict(prompt_lengths=np.array([3, 6, 1], np.int32))
    if case == "int8":
        ours = _port_ids(setup, prompts, 12, 128, dtype=torch.int8)
        expected = _jax_ids(setup, prompts, 12, 128, dtype=jnp.int8)
    else:
        quantize_kv = case == "int8_kv"
        ours = _port_ids(setup, prompts, 12, 128, quantize_kv=quantize_kv, **dict(kw))
        expected = _jax_ids(setup, prompts, 12, 128, quantize_kv=quantize_kv, **dict(kw))
    np.testing.assert_array_equal(ours, expected)
    assert len(set(ours.ravel().tolist())) > 3


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_plain_greedy_past_the_window_matches_jax(quantize_kv):
    """80 steps at cache 256 cross the JAX kernel's 128-row flush and the
    growth of its live cache; with int8 K/V the rows before 128 are read
    quantized from step 128 on."""
    setup = _setup(window=256)
    prompts = np.random.default_rng(2).integers(0, VOCAB, (2, 60)).astype(np.int32)
    ours = _port_ids(setup, prompts, 80, 256, quantize_kv=quantize_kv)
    expected = _jax_ids(setup, prompts, 80, 256, quantize_kv=quantize_kv)
    np.testing.assert_array_equal(ours, expected)


def test_int8_kv_is_exact_before_the_first_window():
    """int8 K/V reads only float rows before position 128: the first tokens
    are bit-identical to float K/V, sampled included, and the state holds
    the int8 triple."""
    _, _, model = _setup(window=256)
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=torch.float32)
    prompts = np.random.default_rng(3).integers(0, VOCAB, (2, 6)).astype(np.int32)
    kw = dict(config=model.config, length=150, cache_len=256, top_k=10)
    ids = {}
    for quantize_kv in (False, True):
        kv = dw.init_kv_state(model.config, 2, 256, torch.float32, quantize_kv)
        ids[quantize_kv], state = dw.megakernel_generate_wide(packed, kv, prompts, 4, 1.0, **kw)
    assert isinstance(state, tuple) and state[0].dtype == torch.int8
    first = 128 - prompts.shape[1] + 1  # samples made at positions < 128
    np.testing.assert_array_equal(ids[True][:, :first].numpy(), ids[False][:, :first].numpy())
    assert (state[0][:, :, :, :155] != 0).any()


def test_reused_state_is_stale_proof():
    """A second generation through the same dirtied state equals a fresh
    one: every row a call reads, it wrote first."""
    setup = _setup()
    model = setup[2]
    rng = np.random.default_rng(5)
    first = rng.integers(0, VOCAB, (2, 30)).astype(np.int32)
    second = rng.integers(0, VOCAB, (2, 9)).astype(np.int32)
    for quantize_kv in (False, True):
        kv = dw.init_kv_state(model.config, 2, 128, torch.float32, quantize_kv)
        _port_ids(setup, first, 90, 128, kv=kv)
        reused = _port_ids(setup, second, 12, 128, kv=kv)
        np.testing.assert_array_equal(reused, _port_ids(setup, second, 12, 128,
                                                        quantize_kv=quantize_kv))


def test_sampled_ids_equal_decode_generate_plain():
    """Both kernels draw the Philox noise of (seed, row, step, lane): the
    wide and fused plain versions sample identical ids, per-row settings and
    a greedy row included."""
    _, _, model = _setup()
    prompts = np.random.default_rng(6).integers(0, VOCAB, (3, 5)).astype(np.int32)
    sampling = dict(temperature=np.array([1.0, 0.0, 0.7], np.float32),
                    top_k=np.array([0, 0, 8], np.int32),
                    top_p=np.array([0.9, 0.0, 0.0], np.float32))
    ours = _port_ids(_setup(), prompts, 20, 128, seed=11, **dict(sampling))
    fused = dk.pack_weights(model.state_dict(), model.config, dtype=torch.float32)
    theirs = megakernel_generate_batched(
        fused, prompts, 11, sampling["temperature"], config=model.config, length=20,
        cache_len=128, top_k=sampling["top_k"], top_p=sampling["top_p"])
    np.testing.assert_array_equal(ours, theirs.numpy())
    assert len(set(ours[0].tolist())) > 3


def test_generate_ids_wide_matches_xla(monkeypatch):
    """``engine="wide"`` on the CPU runs the plain version: greedy ids equal
    the port's and JAX's unfused path and JAX's wide engine, with ragged
    prompts and a batch above the sub-batch cap; a sampled sub-batch i > 0
    draws with the JAX package's chunk seed."""
    jax_model, params, model = _setup()
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, VOCAB, (3, 6)).astype(np.int32)
    plens = np.array([4, 6, 2], np.int32)
    monkeypatch.setattr(gen, "_wide_batch_cap", lambda config, cache_len: 2)
    kwargs = dict(length=7, temperature=0.0, seed=0, cache_len=128, prompt_lengths=plens)
    wide = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompts, engine="wide",
                            **kwargs)
    np.testing.assert_array_equal(
        wide, gen.generate_ids(model, ModelType.TRANSFORMER, None, prompts, engine="xla",
                               **kwargs))
    for engine in ("xla", "wide"):
        np.testing.assert_array_equal(wide, np.asarray(jax_generate_ids(
            jax_model, JaxModelType.TRANSFORMER, params, prompts, engine=engine, **kwargs)))
    engine = gen._WIDE_ENGINE_CACHE["engine"]
    assert engine.packed["wte"].dtype == torch.float32 and list(engine._kv) == [(2, 128)]

    sampled = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompts, length=9,
                               temperature=1.0, seed=5, engine="wide")
    assert gen._WIDE_ENGINE_CACHE["engine"] is engine
    seed1 = (5 * 65537 + 2**16 + 1) % 2**31
    for start, seed in ((0, 5), (2, seed1)):
        rows = prompts[start:start + 2]
        rows = np.concatenate([rows, np.tile(rows[-1:], (2 - len(rows), 1))])
        expected = _port_ids(_setup(), rows, 9, 128, seed=seed, temperature=1.0)
        np.testing.assert_array_equal(sampled[start:start + 2, 6:],
                                      expected[:len(prompts[start:start + 2])])


def test_engine_follows_the_int8_flags(monkeypatch):
    """The int8 flags are read at construction; toggling one builds a new
    engine with int8 weights, then int8 K/V."""
    _, _, model = _setup()
    prompts = np.random.default_rng(8).integers(0, VOCAB, (2, 5)).astype(np.int32)
    kwargs = dict(length=6, temperature=0.0, engine="wide")
    gen.generate_ids(model, ModelType.TRANSFORMER, None, prompts, **kwargs)
    monkeypatch.setenv("COMPOSER_WIDE_INT8", "1")
    out = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompts, **kwargs)
    engine = gen._WIDE_ENGINE_CACHE["engine"]
    assert engine.packed["big_w"].dtype == torch.int8 and not engine.kv_quant
    monkeypatch.setenv("COMPOSER_WIDE_INT8_KV", "1")
    again = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompts, **kwargs)
    engine = gen._WIDE_ENGINE_CACHE["engine"]
    assert engine.kv_quant and isinstance(next(iter(engine._kv.values())), tuple)
    # Six steps stay below position 128, where int8 K/V reads float rows.
    np.testing.assert_array_equal(out, again)


def test_wide_kernel_limits():
    """The sub-batch cap: 8 for the flagship at cache 1152 (shared memory
    196.5 KB: the header, the fp operand 8 x 4096 in bf16 and two 64 KB
    weight stages), fewer rows where embed 4096's B x 4E operand outgrows
    shared memory, and 0 for widths the kernel does not take (embed not a
    multiple of 16, head_dim above 128)."""
    flagship = TransformerConfig(vocab_size=390, embed_dim=1024, window_size=2048,
                                 num_layers=8, num_heads=16, use_relative_attention=True)
    assert gen._wide_batch_cap(flagship, 1152) == 8
    assert dw.wide_smem_bytes(flagship, 8, 1152) == (
        dw.HEADER_BYTES + 4 * 8 * 1024 * 2 + 2 * dw.STAGE_BYTES)
    giant = TransformerConfig(vocab_size=390, embed_dim=4096, window_size=2048,
                              num_layers=8, num_heads=32)
    assert gen._wide_batch_cap(giant, 1152) == 2
    for embed, heads in ((1000, 8), (4096, 16)):
        odd = TransformerConfig(vocab_size=390, embed_dim=embed, window_size=2048,
                                num_heads=heads)
        assert gen._wide_batch_cap(odd, 1152) == 0
    with pytest.raises(ValueError, match="kv_state"):
        _port_ids(_setup(), np.zeros((2, 4), np.int32), 4, 128,
                  kv=dw.init_kv_state(flagship, 2, 128, torch.float32))


CONFIGS = {
    "default": dict(vocab_size=390, embed_dim=256, window_size=1024, num_layers=8,
                    num_heads=16),  # composer_tpu/default_config.yml
    "flagship": dict(vocab_size=390, embed_dim=1024, window_size=2048, num_layers=8,
                     num_heads=16, use_relative_attention=True),  # docs/validation.md
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _parent_kernel_fits(config, batch, cache_len):
    """The admission rule of the kernel before the weight stream: shared
    memory of 64 + 512 floats, the rows' B x E and a union of the B x 4E
    operand, one attention split (q, cache_len scores, 8 floats a thread)
    and the sampler's 4 vocab rows, within 227 KB."""
    E, D = config.embed_dim, config.head_dim
    union = max(batch * 4 * E, D + cache_len + 8 * 512, 4 * dk.vocab_pad(config))
    smem = 4 * (64 + 512 + batch * E + union)
    return (1 <= batch <= 8 and smem <= 232448 and E % 16 == 0 and D % 8 == 0 and D <= 128
            and 512 % D == 0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fit_admits_every_shape_the_parent_admitted(name):
    """Every (batch 1-8, cache 128-2048) the parent's kernel admitted is
    admitted, for every weight dtype, by both kernels (routing follows
    ``wide_kernel_fits``, the service's capacity ``wide_segment_kernel_fits``)."""
    config = TransformerConfig(**CONFIGS[name])
    admitted = 0
    for batch in range(1, 9):
        for cache_len in range(128, 2049, 128):
            if not _parent_kernel_fits(config, batch, cache_len):
                continue
            admitted += 1
            for dtype in DTYPES.values():
                assert dw.wide_kernel_fits(config, batch, cache_len, dtype), (batch, cache_len)
                assert dws.wide_segment_kernel_fits(config, batch, cache_len, dtype)
    assert admitted == 8 * 16


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_smem_and_scratch_follow_the_layout(dtype):
    """``wide_smem_bytes`` and ``_scratch_floats`` spell out the kernel's
    layout (csrc/decode_wide_common.cuh ``smem_bytes``, ``scratch_floats``):
    at the flagship's B=8 the fp operand (B x 4E in the activation dtype)
    is the largest member of the union; at B=1 in bf16 the attention merge
    is (4 warp groups of 16 thread groups of D + 3 floats, for 16-byte loads
    of 8 bf16 a lane, a partial sum a thread, 16 splits' partials of D + 2,
    and 4 for the flag and the groups' max and sum);
    bf16 and int8 add two 64 KB stages."""
    config = TransformerConfig(**CONFIGS["flagship"])
    torch_dtype = DTYPES[dtype]
    abytes = 4 if dtype == "float32" else 2
    stages = 0 if dtype == "float32" else 2 * 65536
    assert dw.HEADER_BYTES == 512 + 4 * (64 + 1024)
    assert dw.wide_smem_bytes(config, 8, 2048, torch_dtype) == (
        dw.HEADER_BYTES + 4 * 8 * 1024 * abytes + stages)
    lanes = 64 // (16 // abytes)
    attention = 4 * (4 * (128 // lanes) * (64 + 3) + 512 + dw.MAX_SPLITS * (64 + 2) + 4)
    union = max(attention, 4 * 1024 * abytes)  # bf16: the attention merge; f32: fp
    assert dw.wide_smem_bytes(config, 1, 2048, torch_dtype) == (
        dw.HEADER_BYTES + -(-union // 128) * 128 + stages)
    for batch in range(1, 9):
        assert dws.wide_segment_smem_bytes(config, batch, 2048, torch_dtype) == \
            dw.wide_smem_bytes(config, batch, 2048, torch_dtype)
    B, E, H, D = 8, 1024, 16, 64
    assert dw._scratch_floats(B, config) == (
        9 * B * E + B * 512 + B * H * dw.MAX_SPLITS * (D + 2) + B * H + 1)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("grid", [1, 64, 132, 264])
def test_every_weight_column_is_streamed_once(grid, name, dtype):
    """The static slices of every streamed matmul phase (``wide_tiles``, the
    mirror of ``tile_geom``): at any grid each (output column, k) of each
    phase lies in exactly one tile of one block below the grid, each tile
    fits a stage, and a block's tiles come in column order."""
    config = TransformerConfig(**CONFIGS[name])
    E, V = config.embed_dim, dk.vocab_pad(config)
    shapes = {"qkv": (3 * E, E), "proj": (E, E), "fc": (4 * E, E), "fp": (E, 4 * E),
              "logits": (V, E)}
    tiles = dw.wide_tiles(config, grid, DTYPES[dtype])
    assert list(tiles) == list(shapes)
    for phase, (N, K) in shapes.items():
        owned = np.zeros((N, K), np.int32)
        last = {}
        for block, col0, cols, k0, klen, size in tiles[phase]:
            assert 0 <= block < grid and size <= dw.STAGE_BYTES
            assert cols % 8 == 0 and cols <= 8 * dw.MAX_TILE_UNITS and klen % 16 == 0
            assert last.get(block, (-1, -1)) < (col0, k0)
            last[block] = (col0, k0)
            owned[col0:col0 + cols, k0:k0 + klen] += 1
        assert (owned == 1).all(), phase
    if grid == 132 and name == "flagship":
        # One tile a phase a block: 24, 8, 32, 8 columns of qkv, proj, fc, fp.
        assert [tiles[p][0][2] for p in shapes] == [24, 8, 32, 8, 8]


@pytest.mark.parametrize("grid", [1, 64, 132, 264])
def test_every_attention_item_is_owned_once(grid):
    """``wide_attention_items`` (the mirror of ``plan_splits`` and the item
    loop): each (row, head)'s keys [0, key_pos] are split into consecutive
    non-empty ranges, at most one for every 64 keys and at most
    ``MAX_SPLITS``, each on one block below the grid, whose warp groups'
    quarters cover it exactly once; at B=8 x 16 heads on 132 blocks a
    (row, head) has one block (no merge across blocks), at B=1 eight."""
    heads = 16
    for key_positions in ([0], [63, 64, 700], [1023] * 8, [5, 100, 2047, 64, 128, 900, 0, 31]):
        items = dw.wide_attention_items(key_positions, heads, grid)
        seen = {}
        for row, head, split, j0, j1, block, quarters in items:
            assert 0 <= block < grid and j1 > j0
            assert len(quarters) == dw.GROUPS_PER_BLOCK
            keys = [j for k0, k1 in quarters for j in range(k0, k1)]
            assert keys == list(range(j0, j1))
            seen.setdefault((row, head), []).append((split, j0, j1))
        assert len(seen) == len(key_positions) * heads
        for (row, _), splits in seen.items():
            n = key_positions[row] + 1
            splits.sort()
            assert [s for s, _, _ in splits] == list(range(len(splits)))
            assert splits[0][1] == 0 and splits[-1][2] == n
            assert all(a[2] == b[1] for a, b in zip(splits, splits[1:]))
            assert len(splits) <= min(dw.MAX_SPLITS, -(-n // dw.MIN_SPLIT_KEYS))
    if grid == 132:
        assert len(dw.wide_attention_items([1023] * 8, heads, grid)) == 8 * heads
        assert len(dw.wide_attention_items([1023], heads, grid)) == heads * 8
