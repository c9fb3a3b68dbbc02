"""The hand-written wide decode kernel (``csrc/decode_wide.cu``) against its
plain PyTorch version on a card.

float32 weights with TF32 off (float or int8 K/V): ids must be identical
(both sides draw the same Philox noise) and the last step's logits within
1e-3 (summation order). int8 weights compute on bf16-rounded activations,
where a different summation order can move a rounding by one bf16 step and
flip a near-tie: the kernel's ids, teacher-forced through the plain
version, are held to the bf16 rule of ``chip_smoke.py``
(``wide_teacher_forced_gap``; run from the repository root, which it
imports from).
These tests import no JAX, so they also run where only PyTorch is
installed. On a machine with a CUDA card and nvcc:

    python -m pytest tests/test_torch_cuda_wide.py -m cuda --noconftest -q

Without a card they skip.
"""

import numpy as np
import pytest
import torch

from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops import decode_kernel_wide as dw
from composer_tpu_torch.ops.decode_kernel_batched import megakernel_generate_batched
from composer_tpu_torch.train import generate as gen

pytestmark = pytest.mark.cuda
LOGIT_TOL = 1e-3  # float32, different summation orders
SAMPLED = dict(temperature=np.array([1.0, 0.0, 0.8, 1.2], np.float32),
               top_k=np.array([0, 0, 20, 5], np.int32),
               top_p=np.array([0.9, 0.0, 0.0, 0.8], np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(use_relative, device):
    config = TransformerConfig(
        vocab_size=390, embed_dim=64, window_size=64, num_layers=2, num_heads=4,
        use_relative_attention=use_relative, initializer_stddev=0.3)
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device).eval()


def _both(packed, config, prompts, plens, sampling, *, length, cache_len, quantize_kv=False,
          grid=0):
    """(kernel ids, plain ids, max |logits difference| at the last step)."""
    device = packed["wte"].device
    B, width = prompts.shape
    greedy, use_k, use_p = dk.sampling_flags(*sampling)
    rows = dk.row_params(B, packed["wte"].shape[0], *sampling, greedy, use_k, use_p, device)
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    plens = torch.as_tensor(plens, dtype=torch.int32, device=device)
    num_steps = width + length - 1
    results = []
    for run in (dw.decode_wide, dw.decode_wide_reference):
        kv = dw.init_kv_state(config, B, cache_len, packed["wte"].dtype, quantize_kv, device)
        logits = torch.zeros((B, packed["wte"].shape[0]), device=device)
        extra = dict(grid=grid) if run is dw.decode_wide else {}
        tokens = run(packed, kv, prompts, plens, 3, *rows, config=config, num_steps=num_steps,
                     out_len=num_steps, cache_len=cache_len, logits_out=logits, **extra)
        torch.cuda.synchronize()
        results.append((tokens.cpu(), logits))
    (ours, lo), (plain, lp) = results
    return ours, plain, float((lo - lp).abs().max())


@pytest.mark.parametrize("use_relative", [False, True])
@pytest.mark.parametrize("weights", ["float32", "float32+int8kv", "int8", "int8+int8kv"])
@pytest.mark.parametrize("sampled", [False, True])
def test_kernel_matches_plain(cuda_device, use_relative, weights, sampled):
    """Ragged prompts, 150 steps at cache 256 (the int8 window completes at
    128), greedy or sampled with per-row top-k / top-p."""
    model = _model(use_relative, cuda_device)
    dtype = torch.int8 if weights.startswith("int8") else torch.float32
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=dtype)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, 390, (4, 9)).astype(np.int32)
    plens = np.array([9, 3, 6, 1], np.int32)
    sampling = (tuple(SAMPLED.values()) if sampled else (0.0, 0, 0.0))
    ours, plain, err = _both(packed, model.config, prompts, plens, sampling, length=142,
                             cache_len=256, quantize_kv=weights.endswith("int8kv"))
    assert len(set(ours.ravel().tolist())) > 10
    if dtype == torch.float32:
        assert torch.equal(ours, plain)
        assert err <= LOGIT_TOL
    else:
        from chip_smoke import wide_teacher_forced_gap

        # Raises where a token falls outside the bf16 rule.
        wide_teacher_forced_gap(packed, model.config, prompts, plens, sampling, ours,
                                cache_len=256, quantize_kv=weights.endswith("int8kv"))


@pytest.mark.parametrize("weights", ["float32", "int8+int8kv"])
def test_smaller_grid_matches_plain(cuda_device, weights):
    """64 blocks, fewer than the card's SMs: every weight tile and attention
    item still lands on some block (several on one), so float32 ids equal
    the plain version's and int8 weights pass the bf16 rule."""
    model = _model(True, cuda_device)
    dtype = torch.int8 if weights.startswith("int8") else torch.float32
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=dtype)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, 390, (4, 9)).astype(np.int32)
    plens = np.array([9, 3, 6, 1], np.int32)
    sampling = tuple(SAMPLED.values())
    quantize_kv = weights.endswith("int8kv")
    ours, plain, err = _both(packed, model.config, prompts, plens, sampling, length=142,
                             cache_len=256, quantize_kv=quantize_kv, grid=64)
    if dtype == torch.float32:
        assert torch.equal(ours, plain)
        assert err <= LOGIT_TOL
    else:
        from chip_smoke import wide_teacher_forced_gap

        wide_teacher_forced_gap(packed, model.config, prompts, plens, sampling, ours,
                                cache_len=256, quantize_kv=quantize_kv)


def test_reused_state_equals_fresh(cuda_device):
    """A second generation through the same dirtied state equals a fresh
    one, float and int8 K/V."""
    model = _model(True, cuda_device)
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=torch.float32)
    rng = np.random.default_rng(2)
    first = rng.integers(0, 390, (2, 40)).astype(np.int32)
    second = rng.integers(0, 390, (2, 9)).astype(np.int32)
    for quantize_kv in (False, True):
        kv = dw.init_kv_state(model.config, 2, 256, torch.float32, quantize_kv, cuda_device)
        kwargs = dict(config=model.config, length=200, cache_len=256)
        dw.megakernel_generate_wide(packed, kv, first, 0, 0.0, **kwargs)
        reused, _ = dw.megakernel_generate_wide(packed, kv, second, 0, 0.0, **kwargs)
        fresh_kv = dw.init_kv_state(model.config, 2, 256, torch.float32, quantize_kv,
                                    cuda_device)
        fresh, _ = dw.megakernel_generate_wide(packed, fresh_kv, second, 0, 0.0, **kwargs)
        assert torch.equal(reused, fresh)


def test_equals_decode_generate(cuda_device):
    """The fused kernel draws the same noise: identical f32 ids, sampled."""
    model = _model(True, cuda_device)
    state = model.state_dict()
    wide = dw.pack_weights_wide(state, model.config, dtype=torch.float32)
    fused = dk.pack_weights(state, model.config, dtype=torch.float32, device=cuda_device)
    prompts = np.random.default_rng(3).integers(0, 390, (4, 7)).astype(np.int32)
    kwargs = dict(config=model.config, length=100, cache_len=128, top_k=SAMPLED["top_k"],
                  top_p=SAMPLED["top_p"])
    kv = dw.init_kv_state(model.config, 4, 128, torch.float32, device=cuda_device)
    ours, _ = dw.megakernel_generate_wide(wide, kv, prompts, 5, SAMPLED["temperature"],
                                          **kwargs)
    theirs = megakernel_generate_batched(fused, prompts, 5, SAMPLED["temperature"], **kwargs)
    assert torch.equal(ours.cpu(), theirs.cpu())


def test_grid_that_cannot_be_resident_raises(cuda_device):
    """A grid whose blocks cannot all be resident would hang at its first
    barrier: the launch is refused."""
    model = _model(False, cuda_device)
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=torch.float32)
    rows = dk.row_params(1, 512, 0.0, 0, 0.0, True, False, False, cuda_device)
    kv = dw.init_kv_state(model.config, 1, 128, torch.float32, device=cuda_device)
    prompts = torch.zeros((1, 4), dtype=torch.int32, device=cuda_device)
    plens = torch.full((1,), 4, dtype=torch.int32, device=cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    with pytest.raises(RuntimeError, match="CUDA error"):
        dw.decode_wide(packed, kv, prompts, plens, 0, *rows, config=model.config, num_steps=8,
                       out_len=8, cache_len=128, grid=64 * sms)
    torch.cuda.synchronize()
    # A grid smaller than the card runs, and agrees with the full grid; the
    # clock counts time in every slot (float32 weights have no weight
    # stream, so no tile wait; bf16 ones fill every slot).
    clock = torch.zeros(len(dw.PHASES), dtype=torch.int64, device=cuda_device)
    ids = [dw.decode_wide(packed, kv, prompts, plens, 0, *rows, config=model.config,
                          num_steps=8, out_len=8, cache_len=128, grid=grid,
                          phase_ns=clock if grid else None).cpu()
           for grid in (3, 0)]
    assert torch.equal(ids[0], ids[1])
    streamless = [i for i, name in enumerate(dw.PHASES) if name != "weight tile wait"]
    assert (clock.cpu()[streamless] > 0).all()
    bf16 = dw.pack_weights_wide(model.state_dict(), model.config, dtype=torch.bfloat16)
    clock.zero_()
    dw.decode_wide(bf16, dw.init_kv_state(model.config, 1, 128, torch.bfloat16,
                                          device=cuda_device),
                   prompts, plens, 0, *rows, config=model.config, num_steps=8, out_len=8,
                   cache_len=128, grid=3, phase_ns=clock)
    assert (clock.cpu() > 0).all()


def test_generate_ids_wide_engine(cuda_device):
    """``engine="wide"`` runs the kernel on the card, in bf16, and batches
    above the cap go out in chunks."""
    model = _model(True, cuda_device)
    prompts = np.random.default_rng(4).integers(0, 390, (3, 5)).astype(np.int32)
    before = dw.decode_wide.launches
    out = gen.generate_ids(model, ModelType.TRANSFORMER, None, prompts, length=20,
                           temperature=1.0, seed=1, engine="wide")
    assert dw.decode_wide.launches == before + 1
    assert out.shape == (3, 25) and (out >= 0).all() and (out < 390).all()
    engine = gen._WIDE_ENGINE_CACHE["engine"]
    assert engine.packed["wte"].dtype == torch.bfloat16
