"""The hand-written CUDA kernel against its plain PyTorch version, on a card.

These tests import no JAX, so they also run where only PyTorch is
installed. On a machine with a CUDA card and nvcc:

    python -m pytest tests/test_torch_cuda_kernel.py -m cuda --noconftest -q

Without a card they skip.
"""

import numpy as np
import pytest
import torch

from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig, init_cache
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops.decode_kernel_batched import (
    decode_generate,
    decode_generate_reference,
)
from composer_tpu_torch.train import generate as gen

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(use_relative, device):
    config = TransformerConfig(
        vocab_size=390, embed_dim=64, window_size=64, num_layers=2, num_heads=4,
        use_relative_attention=use_relative, initializer_stddev=0.3,
    )
    model = Transformer(config)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device).eval()


@pytest.mark.parametrize("use_relative", [False, True])
def test_kernel_matches_plain_version(cuda_device, use_relative):
    """f32: identical greedy and sampled ids, with ragged prompts, mixed
    per-row sampling and a prefill import."""
    model = _model(use_relative, cuda_device)
    config = model.config
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.float32,
                             device=cuda_device)
    prompts = torch.as_tensor(np.random.default_rng(2).integers(0, 390, (4, 9)),
                              dtype=torch.int32, device=cuda_device)
    plens = torch.tensor([9, 6, 8, 7], dtype=torch.int32, device=cuda_device)
    temps, topk, topp = dk.row_params(4, 512, np.array([1.0, 0.0, 0.8, 1.2], np.float32),
                                      np.array([0, 5, 20, 0]),
                                      np.array([0.9, 0.0, 0.0, 0.7], np.float32),
                                      False, True, True, cuda_device)
    cache = init_cache(config, 4, 5, device=cuda_device)
    with torch.no_grad():
        _, cache = model(prompts[:, :5].long(), cache)
    rows = dk.cache_to_rows_batched(cache, config, 128, dtype=torch.float32)
    for start, k_rows, v_rows in ((0, None, None), (5, *rows)):
        kwargs = dict(config=config, num_steps=9 + 40 - 1, out_len=48, cache_len=128,
                      start_step=start)
        args = (packed, prompts, plens, 3, temps, topk, topp, k_rows, v_rows)
        ours = decode_generate(*args, **kwargs)
        plain = decode_generate_reference(*args, **kwargs)
        torch.cuda.synchronize()
        assert torch.equal(ours, plain), f"start_step {start}"


def test_auto_engine_runs_the_kernel_and_matches_unfused_greedy(cuda_device):
    """generate_ids(engine='auto') on the card launches the kernel; with
    f32 packed weights its greedy ids equal the unfused path's."""
    model = _model(True, cuda_device)
    prompts = np.random.default_rng(4).integers(0, 390, (3, 6)).astype(np.int32)
    expected = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompts, length=20,
                                temperature=0.0, engine="xla")
    before = decode_generate.launches_batched
    gen._ENGINE_CACHE["engine"] = gen.TransformerDecoder(model, dtype=torch.float32)
    out = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompts, length=20,
                           temperature=0.0, engine="auto")
    assert decode_generate.launches_batched == before + 1
    np.testing.assert_array_equal(out, expected)


@pytest.mark.parametrize("use_relative", [False, True])
def test_kernel_matches_plain_version_at_full_cache(cuda_device, use_relative):
    """Default widths (E 256, 16 heads, window 1024) at cache_len 1024: the
    16 x 1024 float32 scores need the shared-memory opt-in above 48 KB, and
    the AV product splits over up to 1024 slots. f32 greedy and sampled ids
    identical over 1023 steps, last-step logits within 1e-3."""
    config = TransformerConfig(
        vocab_size=390, embed_dim=256, window_size=1024, num_layers=2, num_heads=16,
        use_relative_attention=use_relative, initializer_stddev=0.3,
    )
    model = Transformer(config)
    model.reset_parameters(torch.Generator().manual_seed(1))
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.float32,
                             device=cuda_device)
    prompts = torch.as_tensor(np.random.default_rng(3).integers(0, 390, (2, 10)),
                              dtype=torch.int32, device=cuda_device)
    plens = torch.full((2,), 10, dtype=torch.int32, device=cuda_device)
    for temperature, top_k, top_p in ((0.0, 0, 0.0), (1.0, 40, 0.9)):
        temps, topk, topp = dk.row_params(2, 512, temperature, top_k, top_p, False, True,
                                          True, cuda_device)
        logits = [torch.zeros((2, 512), device=cuda_device) for _ in range(2)]
        kwargs = dict(config=config, num_steps=1023, out_len=1014, cache_len=1024,
                      start_step=0)
        args = (packed, prompts, plens, 11, temps, topk, topp, None, None)
        ours = decode_generate(*args, **kwargs, logits_out=logits[0])
        plain = decode_generate_reference(*args, **kwargs, logits_out=logits[1])
        torch.cuda.synchronize()
        assert torch.equal(ours, plain), f"temperature {temperature}"
        assert float((logits[0] - logits[1]).abs().max()) <= 1e-3


def test_auto_engine_repacks_weights_changed_in_place(cuda_device):
    """After an in-place weight update the kernel decodes with the new
    weights, not the packed copy of the old ones."""
    model = _model(False, cuda_device)
    prompts = np.random.default_rng(5).integers(0, 390, (2, 6)).astype(np.int32)
    kwargs = dict(length=16, temperature=0.0, engine="auto")
    first = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompts, **kwargs)
    other = Transformer(model.config)
    other.reset_parameters(torch.Generator().manual_seed(9))
    model.load_state_dict(other.state_dict())
    changed = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompts, **kwargs)
    expected = gen.TransformerDecoder(model).generate(prompts, 16, temperature=0.0)
    np.testing.assert_array_equal(changed[:, 6:], expected.cpu().numpy())
    assert not np.array_equal(changed, first)


def test_largest_cache_that_fits_launches(cuda_device):
    """At the default widths the largest cache ``kernel_fits`` admits (its
    limit counts the kernel's static shared state) launches; one more
    raises before the launch."""
    from composer_tpu_torch.ops.decode_kernel_batched import kernel_fits

    config = TransformerConfig(vocab_size=390, num_layers=1)
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.bfloat16,
                             device=cuda_device)
    prompts = torch.arange(4, dtype=torch.int32, device=cuda_device)[None]
    plens = torch.full((1,), 4, dtype=torch.int32, device=cuda_device)
    temps, topk, topp = dk.row_params(1, 512, 0.0, 0, 0.0, True, False, False, cuda_device)
    args = (packed, prompts, plens, 0, temps, topk, topp, None, None)
    kwargs = dict(config=config, num_steps=11, out_len=8, start_step=0)
    assert kernel_fits(config, 3067) and not kernel_fits(config, 3068)
    tokens = decode_generate(*args, **kwargs, cache_len=3067)
    torch.cuda.synchronize()
    assert int(tokens.max()) < 390
    with pytest.raises(ValueError, match="shared memory"):
        decode_generate(*args, **kwargs, cache_len=3068)


def _default_widths(use_relative, dtype, device, seed=2):
    """The default model's widths (E 256, 16 heads of 16, window 1024) at 2
    layers, packed in ``dtype``."""
    config = TransformerConfig(vocab_size=390, num_layers=2, use_relative_attention=use_relative,
                               initializer_stddev=0.3)
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return config, dk.pack_weights(model.state_dict(), config, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ids_do_not_depend_on_batch(cuda_device, dtype):
    """A row's ids do not depend on the batch it runs in, though the batch
    sets the cluster size (``cluster_size``: 16 at B=1, 8 or 16 at B=8, 4 at
    B=32): the rows B=1, 8 and 32 share are equal bit for bit, greedy and
    sampled (the noise is keyed by row and step)."""
    config, packed = _default_widths(True, dtype, cuda_device)
    prompts = torch.as_tensor(np.random.default_rng(8).integers(0, 390, (32, 10)),
                              dtype=torch.int32, device=cuda_device)
    plens = torch.full((32,), 10, dtype=torch.int32, device=cuda_device)
    kwargs = dict(config=config, num_steps=10 + 200 - 1, out_len=200, cache_len=256,
                  start_step=0)
    for temperature, top_k, top_p in ((0.0, 0, 0.0), (1.0, 40, 0.9)):
        runs, clusters = {}, set()
        for batch in (1, 8, 32):
            temps, topk, topp = dk.row_params(batch, 512, temperature, top_k, top_p, False,
                                              True, True, cuda_device)
            runs[batch] = decode_generate(packed, prompts[:batch], plens[:batch], 5, temps,
                                          topk, topp, None, None, **kwargs)
            clusters.add(decode_generate.cluster)
        torch.cuda.synchronize()
        assert len(clusters) >= 2, clusters
        assert torch.equal(runs[1].cpu(), runs[8][:1].cpu()), f"temperature {temperature}"
        assert torch.equal(runs[8].cpu(), runs[32][:8].cpu()), f"temperature {temperature}"
        if temperature == 0.0:
            assert len(set(runs[32].flatten().tolist())) >= 8  # not a degenerate stream


@pytest.mark.parametrize("use_relative", [False, True])
def test_kernel_matches_plain_version_at_batch_32(cuda_device, use_relative):
    """f32 at the default widths with 32 sequences (cluster size 4 or 2 by
    the rule, as the card's GPCs hold 32 clusters of 4): ragged prompts,
    mixed per-row sampling; ids identical to the plain version's, last-step
    logits within 1e-3."""
    config, packed = _default_widths(use_relative, torch.float32, cuda_device, seed=3)
    rng = np.random.default_rng(9)
    prompts = torch.as_tensor(rng.integers(0, 390, (32, 9)), dtype=torch.int32,
                              device=cuda_device)
    plens = torch.as_tensor(rng.integers(1, 10, 32), dtype=torch.int32, device=cuda_device)
    temps, topk, topp = dk.row_params(
        32, 512, rng.choice([0.0, 0.8, 1.0, 1.2], 32).astype(np.float32),
        rng.choice([0, 5, 40], 32), rng.choice([0.0, 0.9], 32).astype(np.float32),
        False, True, True, cuda_device)
    logits = [torch.zeros((32, 512), device=cuda_device) for _ in range(2)]
    kwargs = dict(config=config, num_steps=9 + 120 - 1, out_len=9 + 120 - 1, cache_len=256,
                  start_step=0)
    args = (packed, prompts, plens, 13, temps, topk, topp, None, None)
    ours = decode_generate(*args, **kwargs, logits_out=logits[0])
    plain = decode_generate_reference(*args, **kwargs, logits_out=logits[1])
    torch.cuda.synchronize()
    assert decode_generate.cluster in (2, 4)
    assert torch.equal(ours, plain)
    assert float((logits[0] - logits[1]).abs().max()) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch, cluster", [(48, 2), (80, 1)], ids=["G2", "G1"])
def test_two_and_one_block_clusters(cuda_device, dtype, batch, cluster):
    """The layouts the rule picks for many sequences on 132 SMs: clusters of
    2 from 34 to 66 sequences, and from 67 on the one-block layout in the
    same code. f32: ids identical to the plain version's, last-step logits
    within 1e-3 (ragged prompts, mixed per-row sampling). Both types: row 0
    (sampled) and the last row (greedy) give the ids and last-step logits of
    a B=1 call of that row, bit for bit."""
    config, packed = _default_widths(True, dtype, cuda_device, seed=6)
    rng = np.random.default_rng(batch)
    prompts = torch.as_tensor(rng.integers(0, 390, (batch, 9)), dtype=torch.int32,
                              device=cuda_device)
    plens = torch.as_tensor(rng.integers(1, 10, batch), dtype=torch.int32, device=cuda_device)
    values = [rng.choice([0.0, 0.8, 1.0, 1.2], batch).astype(np.float32),
              rng.choice([0, 5, 40], batch), rng.choice([0.0, 0.9], batch).astype(np.float32)]
    values[0][0], values[0][-1] = 1.0, 0.0
    kwargs = dict(config=config, num_steps=9 + 64 - 1, out_len=9 + 64 - 1, cache_len=128,
                  start_step=0)

    def run(kernel, rows):
        temps, topk, topp = dk.row_params(len(rows), 512, *(v[rows] for v in values), False,
                                          True, True, cuda_device)
        logits = torch.zeros((len(rows), 512), device=cuda_device)
        ids = kernel(packed, prompts[rows], plens[rows], 13, temps, topk, topp, None, None,
                     **kwargs, logits_out=logits)
        return ids.cpu(), logits.cpu()

    ids, logits = run(decode_generate, list(range(batch)))
    assert decode_generate.cluster == cluster
    if dtype == torch.float32:
        plain_ids, plain_logits = run(decode_generate_reference, list(range(batch)))
        assert torch.equal(ids, plain_ids)
        assert float((logits - plain_logits).abs().max()) <= 1e-3
    for row in (0, batch - 1):
        alone_ids, alone_logits = run(decode_generate, [row])
        assert decode_generate.cluster == 16
        assert torch.equal(alone_ids[0], ids[row]), f"row {row}"
        assert torch.equal(alone_logits[0], logits[row]), f"row {row}"
