"""The flash attention kernels against their plain PyTorch version, and one
Trainer step through them, on a card.

These tests import no JAX. On a machine with a CUDA card and nvcc:

    python -m pytest tests/test_torch_cuda_flash.py -m cuda --noconftest -q

Without a card they skip.
"""

import numpy as np
import pytest
import torch

from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.ops import attention
from composer_tpu_torch.ops import flash_attention as fa
from composer_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

# Gradients of the float32 paths, of their scale: the backward's float32
# atomics reorder the dq and dE sums.
F32_GRAD_TOL = 5e-4


def _launched():
    """(forward, backward) flash launches so far, over every route."""
    return (sum(fa.flash_attention_forward.launches.values()),
            sum(fa.flash_attention_backward.launches.values()))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dtype, use_rel, device, B=2, H=2, S=256, D=16, W=512, seed=0):
    rng = np.random.default_rng(seed)

    def tensor(*shape, std=1.0):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32) * std).to(device, dtype)

    q, k, v, dout = (tensor(B, H, S, D) for _ in range(4))
    return q, k, v, tensor(H, W, D, std=0.25) if use_rel else None, dout


@pytest.mark.parametrize("dtype,depth", [
    (dtype, depth) for dtype in (torch.float32, torch.bfloat16) for depth in (16, 32, 64, 128)]
    + [(torch.bfloat16, 48), (torch.float32, 24)])
@pytest.mark.parametrize("use_rel", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernels_match_plain_version(cuda_device, dtype, depth, use_rel, rate):
    """Each route of ``kernel_variant`` at every built head_dim (16, 32, 64,
    128: the float32 split-TF32 kernels, the bf16 ones), and two
    padded widths (bf16 48 runs the D=64 kernels, float32 24 the D=32 ones),
    held by ``chip_smoke.py``'s phase-4 limits (``flash_errors``: float32 O
    and lse 2e-4, gradients 5e-4 of scale; bf16 lse 1e-3, other outputs 2%
    of scale and 2% of each row's norm)."""
    from chip_smoke import flash_errors

    q, k, v, e, dout = _inputs(dtype, use_rel, cuda_device, D=depth)
    seed = torch.tensor([77], dtype=torch.int32, device=cuda_device)
    kw = dict(scale=True, dropout_rate=rate, dropout_seed=seed if rate else None)
    variant = (fa.kernel_variant(dtype, fa.padded_head_dim(dtype, depth)),
               fa.padded_head_dim(dtype, depth))
    launches = _launched()
    before = (fa.flash_attention_forward.launches[variant],
              fa.flash_attention_backward.launches[variant])
    out, lse = fa.flash_attention_forward(q, k, v, e, **kw)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, e, **kw)
    grads = fa.flash_attention_backward(q, k, v, e, ref_out, ref_lse, dout, **kw)
    ref_grads = fa.flash_attention_backward_reference(q, k, v, e, ref_out, ref_lse, dout, **kw)
    torch.cuda.synchronize()
    assert _launched() == (launches[0] + 1, launches[1] + 1)
    assert (fa.flash_attention_forward.launches[variant],
            fa.flash_attention_backward.launches[variant]) == (before[0] + 1, before[1] + 1)
    assert out.shape == q.shape and all(
        ours.shape == plain.shape for ours, plain in zip(grads, ref_grads) if plain is not None)
    pairs = [("O", out, ref_out), ("lse", lse, ref_lse)] + [
        (name, a, b) for name, a, b in zip(("dq", "dk", "dv", "dE"), grads, ref_grads)
        if b is not None]
    for name, ours, plain in pairs:
        report, fault = flash_errors(name, dtype, ours, plain)
        assert fault is None, (name, report, fault)


@pytest.mark.parametrize("dtype,depth", [(torch.float32, 192), (torch.bfloat16, 192),
                                         (torch.float16, 64)])
def test_flash_path_raises_for_an_unbuilt_head_dim(cuda_device, dtype, depth):
    """The routing rule does not look at head_dim or dtype: head_dim 192 or
    float16 on the flash path reaches the wrapper, which raises naming the
    ROADMAP item instead of falling back."""
    q, k, v, _, _ = _inputs(dtype, False, cuda_device, D=depth)
    launches = _launched()
    with pytest.raises(ValueError, match="head_dim.*Queue 2 item 1b"):
        attention.multihead_attention(q, k, v, use_pallas=True)
    assert _launched() == launches


def test_autograd_through_the_kernels(cuda_device):
    """``relative_flash_attention`` on CUDA tensors: gradients reach q, k, v
    and the (f32) table through the kernels and equal the plain version's."""
    q, k, v, e, dout = _inputs(torch.float32, True, cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, e)]
    before = _launched()[1]
    (fa.relative_flash_attention(*leaves) * dout).sum().backward()
    assert _launched()[1] == before + 1
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v, e)]
    (fa.relative_flash_attention(*cpu) * dout.cpu()).sum().backward()
    for leaf, ref in zip(leaves, cpu):
        scale = float(ref.grad.abs().max())
        assert float((leaf.grad.cpu() - ref.grad).abs().max()) <= F32_GRAD_TOL * scale


def test_one_trainer_step_on_the_card(cuda_device):
    """One f32 train step (dropout 0) through the kernels gives the loss and
    the gradients of the same step on the CPU (plain version)."""
    config = TransformerConfig(vocab_size=64, embed_dim=32, window_size=128, num_layers=2,
                               num_heads=2, use_relative_attention=True,
                               attention_dropout_rate=0.0, residual_dropout_rate=0.0,
                               use_pallas_attention=True)
    rng = np.random.default_rng(1)
    x, y = rng.integers(0, 64, (2, 128)), rng.integers(0, 64, (2, 128))
    results = []
    for device in (cuda_device, torch.device("cpu")):
        trainer = Trainer(Transformer(config), ModelType.TRANSFORMER, 1e-3, device=device)
        state = trainer.init_state(2, 128)
        before = _launched()[0]
        loss = float(trainer.train_step(state, x, y)["loss"])
        launched = _launched()[0] - before
        grads = {name: p.grad.cpu() for name, p in state.model.named_parameters()}
        results.append((loss, launched, grads))
    (gpu_loss, gpu_launches, gpu_grads), (cpu_loss, cpu_launches, cpu_grads) = results
    assert (gpu_launches, cpu_launches) == (2, 0)
    assert np.isfinite(gpu_loss) and abs(gpu_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    for name, grad in cpu_grads.items():
        scale = float(grad.abs().max())
        assert float((gpu_grads[name] - grad).abs().max()) <= F32_GRAD_TOL * scale + 1e-7, name


def test_one_float32_trainer_step_at_head_dim_64(cuda_device):
    """One float32 train step (mixed precision off: relative attention,
    dropout, head_dim 64) runs through the split-TF32 kernels at head_dim 64,
    one launch per layer each way, with a finite loss and finite
    gradients."""
    config = TransformerConfig(vocab_size=64, embed_dim=128, window_size=128, num_layers=2,
                               num_heads=2, use_relative_attention=True,
                               attention_dropout_rate=0.1, residual_dropout_rate=0.1,
                               use_pallas_attention=True, dtype=torch.float32)
    rng = np.random.default_rng(4)
    x, y = rng.integers(0, 64, (2, 128)), rng.integers(0, 64, (2, 128))
    trainer = Trainer(Transformer(config), ModelType.TRANSFORMER, 1e-3, device=cuda_device)
    state = trainer.init_state(2, 128)
    before = (fa.flash_attention_forward.launches[("tf32x3", 64)],
              fa.flash_attention_backward.launches[("tf32x3", 64)])
    loss = float(trainer.train_step(state, x, y, trainer.make_dropout_generator())["loss"])
    after = (fa.flash_attention_forward.launches[("tf32x3", 64)],
             fa.flash_attention_backward.launches[("tf32x3", 64)])
    assert (after[0] - before[0], after[1] - before[1]) == (2, 2)
    assert np.isfinite(loss)
    assert all(bool(torch.isfinite(p.grad).all()) for p in state.model.parameters()
               if p.grad is not None)


def test_one_bf16_trainer_step_at_head_dim_64(cuda_device):
    """One bf16 train step (the flagship's recipe at a small size: head_dim
    64, relative attention, dropout) runs through the tensor-core kernels at
    head_dim 64, one launch per layer each way, with a finite loss."""
    config = TransformerConfig(vocab_size=64, embed_dim=128, window_size=128, num_layers=2,
                               num_heads=2, use_relative_attention=True,
                               attention_dropout_rate=0.1, residual_dropout_rate=0.1,
                               use_pallas_attention=True, dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    x, y = rng.integers(0, 64, (2, 128)), rng.integers(0, 64, (2, 128))
    trainer = Trainer(Transformer(config), ModelType.TRANSFORMER, 1e-3, device=cuda_device)
    state = trainer.init_state(2, 128)
    before = (fa.flash_attention_forward.launches[("mma", 64)],
              fa.flash_attention_backward.launches[("mma", 64)])
    loss = float(trainer.train_step(state, x, y, trainer.make_dropout_generator())["loss"])
    after = (fa.flash_attention_forward.launches[("mma", 64)],
             fa.flash_attention_backward.launches[("mma", 64)])
    assert (after[0] - before[0], after[1] - before[1]) == (2, 2)
    assert np.isfinite(loss)


def test_one_bf16_trainer_step_at_head_dim_128(cuda_device):
    """One bf16 train step at head_dim 128 (the embed-2048 architecture's
    heads at a small size: relative attention, dropout) runs through the
    tensor-core kernels at head_dim 128 (the backward's split key groups),
    one launch per layer each way, with a finite loss and finite
    gradients."""
    config = TransformerConfig(vocab_size=64, embed_dim=256, window_size=256, num_layers=2,
                               num_heads=2, use_relative_attention=True,
                               attention_dropout_rate=0.1, residual_dropout_rate=0.1,
                               use_pallas_attention=True, dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    x, y = rng.integers(0, 64, (2, 256)), rng.integers(0, 64, (2, 256))
    trainer = Trainer(Transformer(config), ModelType.TRANSFORMER, 1e-3, device=cuda_device)
    state = trainer.init_state(2, 256)
    before = (fa.flash_attention_forward.launches[("mma", 128)],
              fa.flash_attention_backward.launches[("mma", 128)])
    loss = float(trainer.train_step(state, x, y, trainer.make_dropout_generator())["loss"])
    after = (fa.flash_attention_forward.launches[("mma", 128)],
             fa.flash_attention_backward.launches[("mma", 128)])
    assert (after[0] - before[0], after[1] - before[1]) == (2, 2)
    assert np.isfinite(loss)
    assert all(bool(torch.isfinite(p.grad).all()) for p in state.model.parameters()
               if p.grad is not None)
