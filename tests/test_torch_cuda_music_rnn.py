"""MusicRNN on a card against the same weights on the CPU.

These tests import no JAX. On a machine with a CUDA card:

    python -m pytest tests/test_torch_cuda_music_rnn.py -m cuda --noconftest -q

Without a card they skip. No TPU kernel lies on this path (the LSTM is
cuDNN's ``torch.lstm``), so nothing is built. float32 with TF32 off: logits
within 1e-4 of their scale; bfloat16 compute (parameters float32): within
2% of the scale, the bf16 rule of ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.music_rnn import MusicRNN, MusicRNNConfig, init_state
from composer_tpu_torch.serving import GenerationService
from composer_tpu_torch.train import generate as gen
from composer_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

F32_TOL = 1e-4  # of the logits' scale: other summation orders
BF16_TOL = 0.02  # of the logits' scale: bf16 roundings of the activations
CONFIG = MusicRNNConfig(vocab_size=390, embed_dim=64, layer_sizes=(128, 128),
                        dropout_rates=(0.3, 0.3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _host_model(seed=0):
    model = MusicRNN(CONFIG)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-trivial running statistics
        for norm in model.batch_norms:
            norm.running_mean.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
            norm.running_var.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(2))
    return model


def _tokens(batch=4, length=50, seed=3):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, 390, (batch, length)))


@pytest.mark.parametrize("dtype, tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
def test_forward_on_the_card_matches_the_cpu(cuda_device, dtype, tol):
    """Eval and training-mode forwards (dropout off) with a carry threaded
    through two calls; the running statistics a training forward writes."""
    host = _host_model()
    card = MusicRNN(dataclasses.replace(CONFIG, dtype=dtype, dropout_rates=(0.0, 0.0)))
    card.load_state_dict(host.state_dict())
    card.to(cuda_device)
    host_carry = card_carry = None
    for call in range(2):
        tokens = _tokens(seed=call)
        with torch.no_grad():
            expected, host_carry = host(tokens, host_carry)
            got, card_carry = card(tokens.to(cuda_device), card_carry)
        assert got.dtype == dtype and card_carry[0][0].dtype == dtype
        scale = float(expected.abs().max())
        assert float((got.float().cpu() - expected).abs().max()) <= tol * scale
    host_train = MusicRNN(dataclasses.replace(CONFIG, dropout_rates=(0.0, 0.0)))
    host_train.load_state_dict(host.state_dict())
    with torch.no_grad():
        expected, _ = host_train(_tokens(), deterministic=False)
        got, _ = card(_tokens().to(cuda_device), deterministic=False)
    assert float((got.float().cpu() - expected).abs().max()) <= tol * float(expected.abs().max())
    for ours, theirs in zip(card.batch_norms, host_train.batch_norms):
        np.testing.assert_allclose(ours.running_var.cpu().numpy(),
                                   theirs.running_var.numpy(), rtol=10 * tol)


def test_train_step_keeps_the_batch_norm_statistics_on_the_card(cuda_device):
    model = MusicRNN(dataclasses.replace(CONFIG, dtype=torch.bfloat16))
    trainer = Trainer(model, ModelType.MUSIC_RNN, 1e-3, device=cuda_device)
    state = trainer.init_state(4, 50)
    tokens = _tokens(length=51).numpy()
    generator = trainer.make_dropout_generator()
    carry = trainer.init_rnn_carry(4)
    losses = []
    for _ in range(3):
        metrics = trainer.train_step(state, tokens[:, :-1], tokens[:, 1:], generator, carry)
        carry = metrics["carry"]
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for norm in model.batch_norms:
        assert norm.running_mean.device.type == "cuda"
        assert not bool((norm.running_var == 1).all())
    assert all(t.device.type == "cuda" and t.dtype == torch.bfloat16
               for pair in carry for t in pair)
    assert len(init_state(CONFIG, 2, device=cuda_device)) == 2


def test_generation_service_serves_music_rnn_on_the_card(cuda_device):
    """Greedy responses equal lone ``generate_ids`` runs; nothing is built
    for MusicRNN (no decode kernel serves it)."""
    model = _host_model().to(cuda_device)
    service = GenerationService(model, ModelType.MUSIC_RNN, None, 390, max_wait_ms=50.0)
    try:
        assert service.device.type == "cuda"
        for prompt in ([5, 6, 7], [1, 2, 3, 4, 5]):
            ids = service.submit(np.asarray(prompt), 40, temperature=0.0)
            expected = gen.generate_ids(model, ModelType.MUSIC_RNN, None, np.asarray(prompt),
                                        length=40, temperature=0.0)
            np.testing.assert_array_equal(ids, expected)
        sampled = service.submit(np.asarray([5, 6, 7]), 40, temperature=1.0, top_k=5)
        assert sampled.shape == (43,) and sampled.min() >= 0 and sampled.max() < 390
    finally:
        service.close()
