"""The speculative decoding kernel (csrc/spec_decode.cu) against its plain
PyTorch version, on a card.

These tests import no JAX. On a machine with a CUDA card and nvcc:

    python -m pytest tests/test_torch_cuda_spec.py -m cuda --noconftest -q

Without a card they skip. float32 with TF32 off: tokens and stats must be
identical. In float32 and bfloat16 the kernel's ids must equal the
sequential kernel's (``decode_generate`` at batch 1) bit for bit: every
emitted row is that kernel's step at its position, summed in its order.
"""

import numpy as np
import pytest
import torch

from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops import decode_kernel_spec as dks
from composer_tpu_torch.ops.decode_kernel_batched import decode_generate
from composer_tpu_torch.train import generate as gen

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(use_relative, device, stddev=0.3, seed=0):
    config = TransformerConfig(
        vocab_size=390, embed_dim=64, window_size=64, num_layers=2, num_heads=4,
        use_relative_attention=use_relative, initializer_stddev=stddev,
    )
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def _both(packed, config, prompt, seed, sampling, block, length=64, cache_len=128):
    """(kernel tokens, kernel stats, plain tokens, plain stats) on the host."""
    temps, topk, topp = dk.row_params(1, packed["wte"].shape[0], *sampling, False, True,
                                      True, "cpu")
    args = (packed, torch.as_tensor(prompt, dtype=torch.int32).to(packed["wte"].device),
            seed, float(temps[0]), float(topk[0]), float(topp[0]))
    kwargs = dict(config=config, length=length, cache_len=cache_len, block=block)
    before = dks.spec_decode.launches
    ours = dks.spec_decode(*args, **kwargs)
    assert dks.spec_decode.launches == before + 1
    plain = dks.speculative_generate_reference(*args, **kwargs)
    torch.cuda.synchronize()
    return [t.cpu() for t in (*ours, *plain)]


@pytest.mark.parametrize("block", [2, 3, 5, 16])
@pytest.mark.parametrize("use_relative", [False, True])
def test_kernel_matches_plain_version(cuda_device, use_relative, block):
    model = _model(use_relative, cuda_device)
    packed = dk.pack_weights(model.state_dict(), model.config, dtype=torch.float32,
                             device=cuda_device)
    prompt = np.random.default_rng(block).integers(0, 390, 10)
    for seed, sampling in ((0, (0.0, 0, 0.0)), (5, (1.0, 0, 0.0)), (6, (0.9, 30, 0.9))):
        tokens, stats, plain_tokens, plain_stats = _both(packed, model.config, prompt, seed,
                                                         sampling, block)
        assert torch.equal(tokens, plain_tokens), sampling
        assert torch.equal(stats, plain_stats), (sampling, stats, plain_stats)
        assert int(stats[2]) >= 10 - 1 + 64


def _sequential(packed, config, prompt, seed, sampling, length, cache_len):
    """``decode_generate``'s ids for the same request at batch 1."""
    device = packed["wte"].device
    temps, topk, topp = dk.row_params(1, packed["wte"].shape[0], *sampling, False, True, True,
                                      device)
    prompts = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None]
    plens = torch.full((1,), len(prompt), dtype=torch.int32, device=device)
    ids = decode_generate(packed, prompts, plens, seed, temps, topk, topp, None, None,
                          config=config, num_steps=len(prompt) + length - 1, out_len=length,
                          cache_len=cache_len, start_step=0)
    return ids[0].cpu()


def _default_widths(use_relative, device, num_layers=2):
    """The default model's widths (embed 256, 16 heads of 16, vocab 390:
    clusters of 16 at batch 1) with few layers, random weights."""
    config = TransformerConfig(vocab_size=390, num_layers=num_layers,
                               use_relative_attention=use_relative, initializer_stddev=0.3)
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(4))
    return model.to(device).eval()


@pytest.mark.parametrize("block", [2, 3, 5, 11])
@pytest.mark.parametrize("use_relative", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_ids_equal_the_sequential_kernel(cuda_device, dtype, use_relative, block):
    """Greedy and sampled (top-k and top-p) ids of the speculative kernel
    equal ``decode_generate``'s at batch 1 bit for bit, at the default
    widths (a cluster of 16 blocks), and two launches give the same ids (a
    race between the blocks of the cluster shows as ids that differ only
    sometimes)."""
    model = _default_widths(use_relative, cuda_device)
    config = model.config
    packed = dk.pack_weights(model.state_dict(), config, dtype=dtype, device=cuda_device)
    prompt = np.random.default_rng(block).integers(0, 390, 10)
    for seed, sampling in ((0, (0.0, 0, 0.0)), (5, (0.9, 30, 0.9))):
        temps, topk, topp = dk.row_params(1, packed["wte"].shape[0], *sampling, False, True,
                                          True, "cpu")
        args = (packed, torch.as_tensor(prompt, dtype=torch.int32, device=cuda_device), seed,
                float(temps[0]), float(topk[0]), float(topp[0]))
        kwargs = dict(config=config, length=64, cache_len=128, block=block)
        runs = [dks.spec_decode(*args, **kwargs)[0].cpu() for _ in range(2)]
        assert dks.spec_decode.cluster == 16
        expected = _sequential(packed, config, prompt, seed, sampling, 64, 128)
        assert torch.equal(runs[0], runs[1]), sampling
        assert torch.equal(runs[0], expected), (sampling, runs[0], expected)


@pytest.mark.parametrize("cache_len,block", [(2338, 5), (2671, 3), (1157, 11)])
def test_largest_cache_launches_at_every_cluster_size(cuda_device, monkeypatch, cache_len,
                                                      block):
    """The largest cache ``spec_kernel_fits`` admits at each block launches
    at G = 16 (``cluster_size``'s choice) and at G = 1, the smallest the card
    runs (passes of fewer heads and rows there), and both give the same ids:
    the sums do not depend on G."""
    model = _default_widths(False, cuda_device, num_layers=1)
    config = model.config
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.bfloat16,
                             device=cuda_device)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(0, 390, 6), dtype=torch.int32,
                             device=cuda_device)
    assert dks.spec_kernel_fits(config, cache_len, block)
    assert not dks.spec_kernel_fits(config, cache_len + 1, block)
    ids = {}
    for cluster in (16, 1):
        if cluster == 1:
            monkeypatch.setattr(dks, "launch_cluster_size", lambda *args: 1)
        tokens, stats = dks.spec_decode(packed, prompt, 0, 0.0, 513.0, 2.0, config=config,
                                        length=40, cache_len=cache_len, block=block)
        torch.cuda.synchronize()
        assert dks.spec_decode.cluster == cluster
        assert int(tokens.max()) < 390 and int(stats[2]) >= 6 - 1 + 40
        ids[cluster] = tokens.cpu()
    assert torch.equal(ids[16], ids[1])


def test_kernel_emits_whole_blocks_on_a_repetitive_stream(cuda_device):
    """Near-zero weights: a near-constant greedy stream that the draft
    predicts, so blocks are fully accepted; kernel and plain version agree."""
    model = _model(False, cuda_device, stddev=1e-3, seed=1)
    packed = dk.pack_weights(model.state_dict(), model.config, dtype=torch.float32,
                             device=cuda_device)
    tokens, stats, plain_tokens, plain_stats = _both(
        packed, model.config, np.array([3, 3, 3]), 0, (0.0, 0, 0.0), 6, length=96)
    assert torch.equal(tokens, plain_tokens) and torch.equal(stats, plain_stats)
    assert int(stats[1]) < 96 / 3, stats


def test_auto_engine_runs_the_kernel_for_greedy_batch_1(cuda_device):
    """generate_ids(engine='auto') at batch 1 and temperature 0 launches the
    speculative kernel, not the sequential one; with f32 packed weights its
    ids equal the unfused path's. Sampled auto stays sequential."""
    model = _model(True, cuda_device)
    prompt = np.random.default_rng(7).integers(0, 390, 6).astype(np.int32)
    expected = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompt, length=40,
                                temperature=0.0, engine="xla")
    gen._ENGINE_CACHE["engine"] = gen.TransformerDecoder(model, dtype=torch.float32)
    spec_before, single_before = dks.spec_decode.launches, decode_generate.launches_single
    out = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompt, length=40,
                           temperature=0.0, engine="auto")
    assert dks.spec_decode.launches == spec_before + 1
    assert decode_generate.launches_single == single_before
    np.testing.assert_array_equal(out, expected)
    gen.generate_ids(model, ModelType.TRANSFORMER, None, prompt, length=40,
                     temperature=1.0, engine="auto")
    assert dks.spec_decode.launches == spec_before + 1
    assert decode_generate.launches_single == single_before + 1


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    model = _model(False, cuda_device)
    config = model.config
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.float32,
                             device=cuda_device)
    prompt = torch.arange(5, dtype=torch.int32, device=cuda_device)
    kwargs = dict(config=config, length=16, block=5)
    with pytest.raises(ValueError, match="shared memory"):
        dks.spec_decode(packed, prompt, 0, 0.0, 513.0, 2.0, cache_len=40_000, **kwargs)
    half = {name: t.half() if t.dtype == torch.float32 else t for name, t in packed.items()}
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dks.spec_decode(half, prompt, 0, 0.0, 513.0, 2.0, cache_len=128, **kwargs)
    with pytest.raises(ValueError, match="prompts is on cpu"):
        dks.spec_decode(packed, prompt.cpu(), 0, 0.0, 513.0, 2.0, cache_len=128, **kwargs)
    with pytest.raises(ValueError, match="cache_len"):
        dks.spec_decode(packed, prompt, 0, 0.0, 513.0, 2.0, cache_len=20, **kwargs)


@pytest.mark.parametrize("use_relative", [False, True])
def test_bf16_kernel_tokens_top_their_teacher_forced_rows(cuda_device, use_relative):
    """bfloat16: the kernel's greedy stream, fed back through the plain
    version's bf16 forward, scores each emitted token within 2% of the
    logits' scale of its row's maximum (bf16 near-ties may flip an argmax,
    a wrong kernel is far off)."""
    model = _model(use_relative, cuda_device)
    config = model.config
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.bfloat16,
                             device=cuda_device)
    prompt = np.random.default_rng(3).integers(0, 390, 10)
    tokens, stats, _, _ = _both(packed, config, prompt, 0, (0.0, 0, 0.0), 5, length=200,
                                cache_len=256)
    stream = np.concatenate([prompt, tokens.numpy()])
    rows = dks.teacher_forced_logits(packed, stream, config=config)[9:-1, :390]
    scale = float(rows.abs().max())
    gap = rows.max(-1).values - rows[torch.arange(200), tokens.long().to(cuda_device)]
    assert float(gap.max()) <= 0.02 * scale, (float(gap.max()), scale)
    assert int(stats[1]) >= 1


def test_largest_cache_that_fits_launches(cuda_device):
    """At the default widths, block 5, the largest cache ``spec_kernel_fits``
    admits (its limit counts the kernel's static shared state) launches; one
    more raises before the launch."""
    config = TransformerConfig(vocab_size=390, num_layers=1)
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.bfloat16,
                             device=cuda_device)
    prompt = torch.arange(4, dtype=torch.int32, device=cuda_device)
    assert dks.spec_kernel_fits(config, 2338, 5) and not dks.spec_kernel_fits(config, 2339, 5)
    tokens, stats = dks.spec_decode(packed, prompt, 0, 0.0, 513.0, 2.0, config=config,
                                    length=8, cache_len=2338, block=5)
    torch.cuda.synchronize()
    assert int(tokens.max()) < 390 and int(stats[2]) >= 4 - 1 + 8
    with pytest.raises(ValueError, match="shared memory"):
        dks.spec_decode(packed, prompt, 0, 0.0, 513.0, 2.0, config=config, length=8,
                        cache_len=2339, block=5)
