"""The hand-written streamed-weight segment kernel
(``csrc/decode_wide_segment.cu``) against its plain PyTorch version, and the
continuous service's wide engine, on a card.

float32 weights with TF32 off: ids and carry must be identical (both sides
draw the same Philox noise of (seed, slot, global step)) under any
segmentation. int8 weights compute on bf16-rounded activations, where a
different summation order can move a rounding by one bf16 step and flip a
near-tie: their ids, teacher-forced through ``decode_wide``'s plain version,
are held to the bf16 rule of ``chip_smoke.py`` (``wide_teacher_forced_gap``;
run from the repository root, which it imports from).
These tests import no JAX, so they also run where only PyTorch is
installed. On a machine with a CUDA card and nvcc:

    python -m pytest tests/test_torch_cuda_wide_segment.py -m cuda --noconftest -q

Without a card they skip.
"""

import numpy as np
import pytest
import torch

from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops import decode_kernel_segmented as seg
from composer_tpu_torch.ops import decode_kernel_wide as dw
from composer_tpu_torch.ops import decode_kernel_wide_segmented as dws
from composer_tpu_torch.train import generate as gen

pytestmark = pytest.mark.cuda
CACHE = 256
SAMPLED = (np.array([1.0, 0.0, 0.8, 1.2], np.float32), np.array([0, 0, 20, 5]),
           np.array([0.9, 0.0, 0.0, 0.8], np.float32))
GREEDY = (0.0, 0, 0.0)


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


def _run(packed, config, prompts, plens, starts, boundaries, sampling, *, plain=False,
         live=CACHE, **kwargs):
    """The kernel or its plain version over the segments ``boundaries`` on a
    fresh state: (stream on the host, carry on the host, kv_state)."""
    device = packed["wte"].device
    kv, carry = dws.init_wide_segment_state(packed, config, len(prompts), CACHE)
    rows = dk.row_params(len(prompts), packed["wte"].shape[0], *sampling,
                         *dk.sampling_flags(*sampling), device)
    host = [torch.as_tensor(t, dtype=torch.int32, device=device) for t in (prompts, plens, starts)]
    chunks = []
    for b0, b1 in zip(boundaries[:-1], boundaries[1:]):
        args = dict(config=config, steps=b1 - b0, cache_len=CACHE, live=live)
        if plain:
            tokens = dws.decode_segment_wide_reference(packed, kv, carry, *host, b0, 3, *rows,
                                                       **args)
        else:
            tokens, kv, carry = dws.decode_segment_wide(packed, kv, carry, prompts, plens,
                                                        starts, b0, 3, *sampling, **args,
                                                        **kwargs)
        chunks.append(tokens)
    torch.cuda.synchronize()
    return torch.cat(chunks, dim=1).cpu(), carry.cpu(), kv


PROMPTS = np.random.default_rng(1).integers(0, 390, (4, 9)).astype(np.int32)
PLENS = np.array([9, 3, 6, 1], np.int32)
# Slot 1 arrives at step 20, slot 3 stays parked.
STARTS = np.array([0, 20, 0, seg.PARKED], np.int32)


@pytest.mark.parametrize("use_relative", [False, True])
@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_kernel_matches_plain_under_any_segmentation(cuda_device, use_relative, sampling):
    """Ragged prompts, a late and a parked slot, 150 steps at cache 256 (more
    than one key split a row), segments of 1, 7 and 64."""
    model = _model(use_relative, cuda_device)
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=torch.float32)
    plain, plain_carry, _ = _run(packed, model.config, PROMPTS, PLENS, STARTS, [0, 150],
                                 sampling, plain=True)
    for length in (1, 7, 64):
        boundaries = list(range(0, 150, length)) + [150]
        ours, carry, _ = _run(packed, model.config, PROMPTS, PLENS, STARTS, boundaries,
                              sampling)
        assert torch.equal(ours, plain), f"segments of {length}"
        assert torch.equal(carry, plain_carry)
    assert (ours[3] == -1).all() and (ours[1, :20] == -1).all() and (ours[1, 20:] >= 0).all()
    assert len(set(ours[0].tolist())) > 10


def test_equals_decode_segment_and_decode_wide(cuda_device):
    """Sampled f32 ids and carry equal the resident segment kernel's (the
    same Philox key); greedy ids equal one ``decode_wide`` launch, row by
    row from each row's own position 0."""
    model = _model(True, cuda_device)
    state = model.state_dict()
    packed = dw.pack_weights_wide(state, model.config, dtype=torch.float32)
    resident = dk.pack_weights(state, model.config, dtype=torch.float32, device=cuda_device)
    ours, carry, _ = _run(packed, model.config, PROMPTS, PLENS, STARTS, [0, 64, 128, 150],
                          SAMPLED)
    kcache, vcache, rcarry = seg.init_segment_state(resident, model.config, 4, CACHE)
    theirs, *_ = seg.decode_segment(resident, kcache, vcache, rcarry, PROMPTS, PLENS, STARTS,
                                    0, 3, *SAMPLED, config=model.config, steps=150,
                                    cache_len=CACHE, live=CACHE)
    assert torch.equal(ours, theirs.cpu()) and torch.equal(carry, rcarry.cpu())

    greedy, _, _ = _run(packed, model.config, PROMPTS, PLENS, STARTS, [0, 64, 128, 150],
                        GREEDY)
    kv = dw.init_kv_state(model.config, 4, CACHE, torch.float32, device=cuda_device)
    whole, _ = dw.megakernel_generate_wide(packed, kv, PROMPTS, 0, 0.0, config=model.config,
                                           length=142, cache_len=CACHE, prompt_lengths=PLENS)
    whole = whole.cpu()
    for row in range(3):
        start, plen = int(STARTS[row]), int(PLENS[row])
        count = min(150 - start - plen + 1, whole.shape[1])
        assert torch.equal(greedy[row, start + plen - 1:][:count], whole[row, :count]), \
            f"row {row}"


def test_int8_weights_pass_the_bf16_rule(cuda_device):
    """int8 weights, every slot from step 0: each row's ids, teacher-forced
    through ``decode_wide``'s plain version with the kernel's noise, pass
    the bf16 rule."""
    from chip_smoke import wide_teacher_forced_gap

    model = _model(True, cuda_device)
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=torch.int8)
    starts = np.zeros(4, np.int32)
    ours, _, kv = _run(packed, model.config, PROMPTS, PLENS, starts, [0, 64, 128, 150],
                       SAMPLED)
    assert kv.dtype == torch.bfloat16
    # decode_wide's layout: row b's sample at step p in column p - plen + 1.
    ids = torch.full((4, 150), 0, dtype=torch.int32)
    for row, plen in enumerate(PLENS):
        ids[row, :150 - plen + 1] = ours[row, plen - 1:]
    wide_teacher_forced_gap(packed, model.config, PROMPTS, PLENS, SAMPLED, ids,
                            cache_len=CACHE)


@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_smaller_grid_matches_plain(cuda_device, sampling):
    """64 blocks, fewer than the card's SMs, segments of 7: every weight
    tile and attention item still lands on some block, so ids and carry
    equal the plain version's."""
    model = _model(True, cuda_device)
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=torch.float32)
    plain, plain_carry, _ = _run(packed, model.config, PROMPTS, PLENS, STARTS, [0, 150],
                                 sampling, plain=True)
    boundaries = list(range(0, 150, 7)) + [150]
    ours, carry, _ = _run(packed, model.config, PROMPTS, PLENS, STARTS, boundaries, sampling,
                          grid=64)
    assert torch.equal(ours, plain) and torch.equal(carry, plain_carry)


def test_lingering_row_writes_nothing(cuda_device):
    """A row whose position passes ``live`` attends to [0, live) and writes
    nothing past it; kernel and plain version agree on its samples."""
    model = _model(True, cuda_device)
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=torch.float32)
    starts = np.array([0, 0, 100, seg.PARKED], np.int32)
    ours, carry, kv = _run(packed, model.config, PROMPTS, PLENS, starts, [0, 80, 150],
                           SAMPLED, live=64)
    plain, plain_carry, _ = _run(packed, model.config, PROMPTS, PLENS, starts, [0, 80, 150],
                                 SAMPLED, live=64, plain=True)
    assert torch.equal(ours, plain) and torch.equal(carry, plain_carry)
    assert (kv[:, :, :, 64:] == 0).all()


def test_grid_that_cannot_be_resident_raises(cuda_device):
    """A grid whose blocks cannot all be resident would hang at its first
    barrier: the launch is refused. A smaller grid agrees with the full one,
    and the clock counts time in every phase."""
    model = _model(False, cuda_device)
    packed = dw.pack_weights_wide(model.state_dict(), model.config, dtype=torch.float32)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    with pytest.raises(RuntimeError, match="CUDA error"):
        _run(packed, model.config, PROMPTS, PLENS, STARTS, [0, 8], GREEDY, grid=64 * sms)
    torch.cuda.synchronize()
    clock = torch.zeros(len(dws.PHASES), dtype=torch.int64, device=cuda_device)
    small, _, _ = _run(packed, model.config, PROMPTS, PLENS, STARTS, [0, 30], SAMPLED, grid=3,
                       phase_ns=clock)
    full, _, _ = _run(packed, model.config, PROMPTS, PLENS, STARTS, [0, 30], SAMPLED)
    assert torch.equal(small, full)
    # float32 weights have no weight stream, so no tile wait.
    streamless = [i for i, name in enumerate(dws.PHASES) if name != "weight tile wait"]
    assert (clock.cpu()[streamless] > 0).all()


def test_service_wide_engine_launches_the_kernel(cuda_device):
    """``ContinuousGenerationService(engine="wide")`` on the card (f32
    weights) launches the wide segment kernel and not the resident one; its
    greedy responses equal ``generate_ids(engine="xla")``."""
    from composer_tpu_torch.serving import ContinuousGenerationService

    model = _model(False, cuda_device)
    service = ContinuousGenerationService(model, ModelType.TRANSFORMER, None, 390, slots=3,
                                          seg_steps=8, cache_len=CACHE, dtype=torch.float32,
                                          engine="wide")
    try:
        assert service.wide
        before = (dws.decode_segment_wide.launches, seg.decode_segment.launches)
        prompts = [[5, 100, 300, 17], [9], [1, 2, 3], [7, 8]]
        outputs = [service.submit(p, 20, temperature=0.0, deadline_ms=60_000)
                   for p in prompts]
        assert dws.decode_segment_wide.launches > before[0]
        assert seg.decode_segment.launches == before[1]
    finally:
        service.close()
    for prompt, out in zip(prompts, outputs):
        expected = gen.generate_ids(model, ModelType.TRANSFORMER, None,
                                    np.asarray(prompt, np.int32), length=20, temperature=0.0,
                                    engine="xla")
        np.testing.assert_array_equal(out, expected)
