"""The hand-written segmented decode kernel (``csrc/decode_segment.cu``) against
its plain PyTorch version, and the continuous service on a card.

These tests import no JAX, so they also run where only PyTorch is
installed. On a machine with a CUDA card and nvcc:

    python -m pytest tests/test_torch_cuda_segment.py -m cuda --noconftest -q

Without a card they skip.
"""

import numpy as np
import pytest
import torch

from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.ops import decode_kernel as dk
from composer_tpu_torch.ops import decode_kernel_segmented as seg
from composer_tpu_torch.ops.decode_kernel_batched import megakernel_generate_batched
from composer_tpu_torch.train import generate as gen

pytestmark = pytest.mark.cuda
CACHE = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(use_relative, device, **kwargs):
    config = TransformerConfig(
        vocab_size=390, embed_dim=64, window_size=64, num_layers=2, num_heads=4,
        use_relative_attention=use_relative, initializer_stddev=0.3, **kwargs)
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device).eval()


def _both(packed, config, prompts, plens, starts, boundaries, sampling, live=CACHE):
    """Kernel and plain version over the same segmentation, each on its own
    state: ((stream, kcache, carry) of the kernel, the same of the plain)."""
    return [_segments(run, packed, config, prompts, plens, starts, boundaries, sampling, live)
            for run in (seg.decode_segment, _plain)]


def _segments(run, packed, config, prompts, plens, starts, boundaries, sampling, live=CACHE):
    """``run`` (the kernel or the plain version) over the segmentation from a
    fresh state: (stream, kcache, carry)."""
    kcache, vcache, carry = seg.init_segment_state(packed, config, prompts.shape[0], CACHE)
    chunks = []
    for b0, b1 in zip(boundaries[:-1], boundaries[1:]):
        tokens, kcache, vcache, carry = run(
            packed, kcache, vcache, carry, prompts, plens, starts, b0, 3, *sampling,
            config=config, steps=b1 - b0, cache_len=CACHE, live=live)
        chunks.append(tokens)
    torch.cuda.synchronize()
    return torch.cat(chunks, dim=1).cpu(), kcache, carry.cpu()


def _plain(packed, kcache, vcache, carry, prompts, plens, starts, step0, seed, temperature,
           top_k, top_p, **kwargs):
    device = packed["wte"].device
    flags = dk.sampling_flags(temperature, top_k, top_p)
    temps, topk, topp = dk.row_params(prompts.shape[0], packed["wte"].shape[0], temperature,
                                      top_k, top_p, *flags, device)
    as_int = [torch.as_tensor(t, dtype=torch.int32, device=device)
              for t in (prompts, plens, starts)]
    return seg.decode_segment_reference(packed, kcache, vcache, carry, *as_int, step0, seed,
                                        temps, topk, topp, **kwargs)


SAMPLED = (np.array([1.0, 0.0, 0.8, 1.2], np.float32), np.array([0, 5, 20, 0]),
           np.array([0.9, 0.0, 0.0, 0.7], np.float32))
GREEDY = (0.0, 0, 0.0)


@pytest.mark.parametrize("use_relative", [False, True])
@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_kernel_matches_plain_version_under_any_segmentation(cuda_device, use_relative,
                                                             sampling):
    """f32: identical ids, carry and caches, kernel against plain version,
    for segments of 1, 7 and 64 steps; and one stream for all three."""
    model = _model(use_relative, cuda_device)
    packed = dk.pack_weights(model.state_dict(), model.config, dtype=torch.float32,
                             device=cuda_device)
    prompts = np.random.default_rng(2).integers(0, 390, (4, 9)).astype(np.int32)
    plens = np.array([9, 6, 1, 7], np.int32)
    starts = np.array([0, 0, 3, 0], np.int32)
    streams = []
    for step in (1, 7, 64):
        boundaries = list(range(0, 64, step)) + [64]
        (ours, kc, carry), (plain, kc_plain, carry_plain) = _both(
            packed, model.config, prompts, plens, starts, boundaries, sampling)
        assert torch.equal(ours, plain), f"segments of {step}"
        assert torch.equal(carry, carry_plain)
        assert torch.equal(kc, kc_plain) or float((kc - kc_plain).abs().max()) < 1e-4
        streams.append(ours)
    assert torch.equal(streams[0], streams[1]) and torch.equal(streams[0], streams[2])
    assert (streams[0][2, :3] == -1).all() and (streams[0][:, 3:] >= 0).all()


def test_admission_and_parked_slots(cuda_device):
    """Slot 3 is parked for a segment and then admitted mid-segment; slot 2
    stays parked. Kernel and plain version agree on ids and carry, the
    parked slot emits -1 and leaves its rows alone, and the admitted row
    decodes exactly its fresh run through decode_generate."""
    model = _model(True, cuda_device)
    config = model.config
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.float32,
                             device=cuda_device)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, 390, (4, 6)).astype(np.int32)
    plens = np.array([6, 4, 1, 5], np.int32)
    results = []
    for run in (seg.decode_segment, _plain):
        state = list(seg.init_segment_state(packed, config, 4, CACHE))
        state[0].normal_()
        before = state[0].clone()
        chunks = []
        for b0, b1, start3 in ((0, 10, seg.PARKED), (10, 40, 13)):
            starts = np.array([0, 0, seg.PARKED, start3], np.int32)
            tokens, *state = run(packed, *state, prompts, plens, starts, b0, 0, 0.0, 0, 0.0,
                                 config=config, steps=b1 - b0, cache_len=CACHE, live=CACHE)
            chunks.append(tokens)
        torch.cuda.synchronize()
        stream = torch.cat(chunks, dim=1).cpu()
        rows = state[0].view(config.num_layers, 4, CACHE, -1)
        assert torch.equal(rows[:, 2], before.view(config.num_layers, 4, CACHE, -1)[:, 2])
        results.append((stream, state[2].cpu()))
    (ours, carry), (plain, carry_plain) = results
    assert torch.equal(ours, plain) and torch.equal(carry, carry_plain)
    assert (ours[2] == -1).all() and (ours[3, :13] == -1).all()
    fresh = megakernel_generate_batched(packed, prompts[3:4, :5], 0, 0.0, config=config,
                                        length=40 - 13 - 4, cache_len=CACHE)
    torch.cuda.synchronize()
    assert torch.equal(ours[3, 13 + 4:], fresh[0].cpu())


def test_lingering_row_past_the_cache_does_not_touch_the_next_slot(cuda_device):
    """Slot 0 runs past cache_len with live = cache_len: it writes nothing,
    so slot 1, admitted meanwhile, decodes exactly its fresh run."""
    model = _model(True, cuda_device)
    config = model.config
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.float32,
                             device=cuda_device)
    prompts = np.random.default_rng(6).integers(0, 390, (2, 6)).astype(np.int32)
    plens = np.array([4, 6], np.int32)
    state = seg.init_segment_state(packed, config, 2, CACHE)
    _, *state = seg.decode_segment(packed, *state, prompts, plens,
                                   np.array([0, seg.PARKED], np.int32), 0, 0, 0.0, 0, 0.0,
                                   config=config, steps=CACHE - 8, cache_len=CACHE, live=CACHE)
    tokens, *state = seg.decode_segment(packed, *state, prompts, plens,
                                        np.array([0, CACHE - 8], np.int32), CACHE - 8, 0, 0.0,
                                        0, 0.0, config=config, steps=16, cache_len=CACHE,
                                        live=CACHE)
    fresh = megakernel_generate_batched(packed, prompts[1:], 0, 0.0, config=config, length=11,
                                        cache_len=CACHE)
    torch.cuda.synchronize()
    assert torch.equal(tokens[1, 5:].cpu(), fresh[0].cpu())


def test_bf16_greedy_ids_equal_decode_generate(cuda_device):
    """Both kernels run one step body: bf16 greedy ids agree bit for bit at
    the default widths (2 layers)."""
    config = TransformerConfig(vocab_size=390, num_layers=2, use_relative_attention=True,
                               initializer_stddev=0.3)
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(1))
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.bfloat16,
                             device=cuda_device)
    prompts = np.random.default_rng(7).integers(0, 390, (3, 10)).astype(np.int32)
    plens = np.full(3, 10, np.int32)
    state = seg.init_segment_state(packed, config, 3, 512)
    chunks = []
    for b0 in range(0, 300, 64):
        tokens, *state = seg.decode_segment(packed, *state, prompts, plens,
                                            np.zeros(3, np.int32), b0, 0, 0.0, 0, 0.0,
                                            config=config, steps=64, cache_len=512, live=512)
        chunks.append(tokens)
    stream = torch.cat(chunks, dim=1)[:, 9:9 + 280]
    fused = megakernel_generate_batched(packed, prompts, 0, 0.0, config=config, length=280,
                                        cache_len=512)
    torch.cuda.synchronize()
    assert torch.equal(stream.cpu(), fused.cpu())


def test_largest_live_that_fits_launches(cuda_device):
    """At the default widths the largest ``live`` that ``segment_kernel_fits``
    admits launches; one more raises before the launch."""
    config = TransformerConfig(vocab_size=390, num_layers=1)
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    packed = dk.pack_weights(model.state_dict(), config, dtype=torch.bfloat16,
                             device=cuda_device)
    state = seg.init_segment_state(packed, config, 1, 3072)
    prompts = np.arange(4, dtype=np.int32)[None]
    args = (np.full(1, 4, np.int32), np.zeros(1, np.int32), 0, 0, 0.0, 0, 0.0)
    assert seg.segment_kernel_fits(config, 3067) and not seg.segment_kernel_fits(config, 3068)
    tokens, *state = seg.decode_segment(packed, *state, prompts, *args, config=config,
                                        steps=8, cache_len=3072, live=3067)
    torch.cuda.synchronize()
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 390
    with pytest.raises(ValueError, match="shared memory"):
        seg.decode_segment(packed, *state, prompts, *args, config=config, steps=8,
                           cache_len=3072, live=3068)


def test_service_launches_the_kernel_and_matches_the_unfused_path(cuda_device):
    """The continuous service on the card (f32 weights) launches the segment
    kernel; its greedy responses equal generate_ids(engine="xla")."""
    from composer_tpu_torch.serving import ContinuousGenerationService

    model = _model(False, cuda_device)
    service = ContinuousGenerationService(model, ModelType.TRANSFORMER, None, 390, slots=3,
                                          seg_steps=8, cache_len=CACHE, dtype=torch.float32)
    try:
        before = seg.decode_segment.launches
        prompts = [[5, 100, 300, 17], [9], [1, 2, 3], [7, 8]]
        outputs = [service.submit(p, 20, temperature=0.0, deadline_ms=60_000)
                   for p in prompts]
        assert seg.decode_segment.launches > before
    finally:
        service.close()
    for prompt, out in zip(prompts, outputs):
        expected = gen.generate_ids(model, ModelType.TRANSFORMER, None,
                                    np.asarray(prompt, np.int32), length=20, temperature=0.0,
                                    engine="xla")
        np.testing.assert_array_equal(out, expected)


def _default_widths(dtype, device, seed=4):
    """The default model's widths (E 256, 16 heads of 16) at 2 layers,
    relative attention on, packed in ``dtype``."""
    config = TransformerConfig(vocab_size=390, num_layers=2, use_relative_attention=True,
                               initializer_stddev=0.3)
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return config, dk.pack_weights(model.state_dict(), config, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ids_do_not_depend_on_batch(cuda_device, dtype):
    """A slot's ids do not depend on how many slots the service runs, though
    that count sets the cluster size: the slots that 1, 8 and 32 share give
    equal ids and carry bit for bit over three segments, greedy and sampled."""
    config, packed = _default_widths(dtype, cuda_device)
    prompts = np.random.default_rng(10).integers(0, 390, (32, 10)).astype(np.int32)
    plens = np.full(32, 10, np.int32)
    for sampling in (GREEDY, (1.0, 40, 0.9)):
        runs, clusters = {}, set()
        for slots in (1, 8, 32):
            state = seg.init_segment_state(packed, config, slots, 256)
            chunks = []
            for b0 in range(0, 192, 64):
                tokens, *state = seg.decode_segment(
                    packed, *state, prompts[:slots], plens[:slots],
                    np.zeros(slots, np.int32), b0, 5, *sampling, config=config, steps=64,
                    cache_len=256, live=256)
                chunks.append(tokens)
                clusters.add(seg.decode_segment.cluster)
            runs[slots] = (torch.cat(chunks, dim=1).cpu(), state[2].cpu())
        torch.cuda.synchronize()
        assert len(clusters) >= 2, clusters
        for small, large in ((1, 8), (8, 32)):
            assert torch.equal(runs[small][0], runs[large][0][:small]), (sampling, small)
            assert torch.equal(runs[small][1], runs[large][1][:small]), (sampling, small)


def test_kernel_matches_plain_version_at_32_slots(cuda_device):
    """f32 at the default widths with 32 slots (cluster size 4 or 2 by the
    rule, as the card's GPCs hold 32 clusters of 4):
    ragged prompts, mixed per-row sampling, parked and late slots, segments
    of 7 and 64: ids and carry identical to the plain version's."""
    config, packed = _default_widths(torch.float32, cuda_device, seed=5)
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, 390, (32, 9)).astype(np.int32)
    plens = rng.integers(1, 10, 32).astype(np.int32)
    starts = rng.choice([0, 0, 0, 5, 40], 32).astype(np.int32)
    starts[3] = seg.PARKED
    sampling = (rng.choice([0.0, 0.8, 1.0], 32).astype(np.float32), rng.choice([0, 5, 40], 32),
                rng.choice([0.0, 0.9], 32).astype(np.float32))
    for step in (7, 64):
        boundaries = list(range(0, 120, step)) + [120]
        (ours, _, carry), (plain, _, carry_plain) = _both(
            packed, config, prompts, plens, starts, boundaries, sampling)
        assert seg.decode_segment.cluster in (2, 4)
        assert torch.equal(ours, plain), f"segments of {step}"
        assert torch.equal(carry, carry_plain)
        assert (ours[3] == -1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slots, cluster", [(48, 2), (80, 1)], ids=["G2", "G1"])
def test_two_and_one_block_clusters(cuda_device, dtype, slots, cluster):
    """The layouts the rule picks for many slots on 132 SMs: clusters of 2
    from 34 to 66 slots, and from 67 on the one-block layout in the same
    code. f32: ids and carry identical to the plain version's (ragged
    prompts, mixed per-row sampling, parked and late slots, segments of 7
    and 64). Both types: slot 0 (sampled) and the last slot (greedy) give
    the ids and carry of a one-slot run, bit for bit."""
    config, packed = _default_widths(dtype, cuda_device, seed=7)
    rng = np.random.default_rng(slots)
    prompts = rng.integers(0, 390, (slots, 9)).astype(np.int32)
    plens = rng.integers(1, 10, slots).astype(np.int32)
    starts = rng.choice([0, 0, 0, 5, 40], slots).astype(np.int32)
    starts[[0, -1]] = 0
    starts[3] = seg.PARKED
    sampling = [rng.choice([0.0, 0.8, 1.0], slots).astype(np.float32),
                rng.choice([0, 5, 40], slots), rng.choice([0.0, 0.9], slots).astype(np.float32)]
    sampling[0][0], sampling[0][-1] = 1.0, 0.0
    for step in (7, 64):
        boundaries = list(range(0, 120, step)) + [120]
        ours, _, carry = _segments(seg.decode_segment, packed, config, prompts, plens, starts,
                                   boundaries, sampling)
        assert seg.decode_segment.cluster == cluster
        assert (ours[3] == -1).all()
        if dtype == torch.float32:
            plain, _, carry_plain = _segments(_plain, packed, config, prompts, plens, starts,
                                              boundaries, sampling)
            assert torch.equal(ours, plain), f"segments of {step}"
            assert torch.equal(carry, carry_plain)
        for slot in (0, slots - 1):
            alone, _, alone_carry = _segments(
                seg.decode_segment, packed, config, prompts[[slot]], plens[[slot]],
                starts[[slot]], boundaries, [v[[slot]] for v in sampling])
            assert seg.decode_segment.cluster == 16
            assert torch.equal(alone[0], ours[slot]), f"slot {slot}, segments of {step}"
            assert torch.equal(alone_carry[0], carry[slot])


def test_admission_prefill_and_prefix_cache_on_the_card(cuda_device):
    """The continuous service's admission prefill and prefix cache on the
    card, float32 (``chip_smoke.py`` phase 10e): a 100-event prompt gives
    identical greedy ids admitted token by token, with the prefill forward
    and from a prefix-cache hit, and the hit counter rises once."""
    from chip_smoke import admission_prefill_case

    config = TransformerConfig(vocab_size=390, num_layers=2, initializer_stddev=0.3)
    model = Transformer(config, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(6))
    case = admission_prefill_case(model.to(cuda_device).eval(), cuda_device)
    assert case["stats"]["prefix_cache_hits"] == 1 and case["stats"]["prefix_cache_entries"] == 2
    forced = case["outputs"]["forced"]
    assert all(len(ids) == 164 for ids in forced)
    assert len(set(forced[0][100:].tolist())) > 4  # not a degenerate stream
