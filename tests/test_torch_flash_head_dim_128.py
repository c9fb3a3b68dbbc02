"""The embed-2048 architecture's attention shape, head_dim 128, at a small
size: a 2-layer Transformer (embed 256, 2 heads of 128, window 256,
relative attention, dropout 0) with ``use_pallas_attention`` in both
packages, on the same weights (``params_from_flax``), f32 on the CPU.

The JAX model runs its Pallas flash kernels in interpret mode; the port's
runs ``ops/flash_attention.py``, whose wrappers take the plain version on
CPU tensors (tests/test_torch_cuda_flash.py holds the D=128 kernels to it
on a card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composer_tpu.models import ModelType as JaxModelType
from composer_tpu.models.transformer import Transformer as JaxTransformer
from composer_tpu.models.transformer import TransformerConfig as JaxConfig
from composer_tpu.train.trainer import Trainer as JaxTrainer
from composer_tpu.train.trainer import cross_entropy_and_accuracy as jax_loss
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.convert import params_from_flax, params_to_flax
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.train.trainer import Trainer, cross_entropy_and_accuracy

VOCAB, WINDOW, BATCH, LR = 64, 256, 2, 1e-3
# The f32 tolerances of tests/test_torch_trainer.py: the loss within 2e-6
# relative, weights after an Adam step within 5e-6 (the two frameworks sum
# in different orders).
LOSS_TOL = 2e-6
PARAM_ATOL = 5e-6
# Gradients, of each tensor's largest entry: the flash backward's tolerance
# (tests/test_torch_flash_attention.py), summed in different orders.
GRAD_TOL = 5e-4
# Adam's first update is lr g / (|g| + eps), eps 1e-7: where |g| is within
# 10 eps, f32 summation noise in g (about 2e-9 here, on gradients of scale
# 0.05) moves the update by up to 1% of lr, and where g is 0 but for that
# noise (the key projection's bias: a constant shift of a row's scores) by
# up to lr times noise / eps. Those weights are held to a tenth of a step (a
# wrong update moves them by about lr), the rest to PARAM_ATOL.
ADAM_EPS = 1e-7
NEAR_ZERO_STEP_TOL = 0.1 * LR

KWARGS = dict(vocab_size=VOCAB, embed_dim=256, window_size=WINDOW, num_layers=2, num_heads=2,
              use_relative_attention=True, attention_dropout_rate=0.0,
              residual_dropout_rate=0.0, use_pallas_attention=True)


def _flat(params):
    return {k: np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, VOCAB, (BATCH, WINDOW + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


@pytest.fixture(scope="module")
def jax_trainer_step(batch):
    """The JAX Trainer's init, the loss and gradients there, and one
    ``train_step`` (its loss and the updated params)."""
    trainer = JaxTrainer(JaxTransformer(JaxConfig(**KWARGS)), JaxModelType.TRANSFORMER, LR)
    state = trainer.init_state(BATCH, WINDOW)
    init = jax.device_get(state.params)
    x, y = (jnp.asarray(a) for a in batch)

    def loss(params):
        logits, _ = trainer.model.apply({"params": params}, x, deterministic=False,
                                        rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_loss(logits, y)[0]

    value, grads = jax.value_and_grad(loss)(state.params)
    state, metrics, _ = trainer.train_step(state, x, y, jax.random.PRNGKey(0), None)
    return (init, float(value), jax.device_get(grads), float(metrics["loss"]),
            jax.device_get(state.params))


def test_head_dim_128_loss_and_gradients_match_jax(batch, jax_trainer_step):
    init, expected_loss, expected_grads, _, _ = jax_trainer_step
    config = TransformerConfig(**KWARGS)
    assert config.embed_dim // config.num_heads == 128
    model = Transformer(config)
    model.load_state_dict(params_from_flax(init, config))
    x, y = (torch.as_tensor(a).long() for a in batch)
    logits, _ = model(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    loss, _ = cross_entropy_and_accuracy(logits, y)
    loss.backward()
    np.testing.assert_allclose(float(loss), expected_loss, rtol=LOSS_TOL)
    grads = params_to_flax({name: p.grad for name, p in model.named_parameters()}, config)
    expected = _flat(expected_grads)
    got = _flat(grads)
    assert got.keys() == expected.keys()
    for path, want in expected.items():
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got[path], want, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=str(path))


def test_head_dim_128_trainer_step_matches_jax(batch, jax_trainer_step):
    init, _, jax_grads, expected_loss, expected_params = jax_trainer_step
    trainer = Trainer(Transformer(TransformerConfig(**KWARGS)), ModelType.TRANSFORMER, LR,
                      device="cpu")
    state = trainer.init_state(BATCH, WINDOW)
    state.model.load_state_dict(params_from_flax(init, state.model.config))
    loss = float(trainer.train_step(state, *batch)["loss"])
    np.testing.assert_allclose(loss, expected_loss, rtol=LOSS_TOL)
    ours = _flat(params_to_flax(state.model.state_dict(), state.model.config))
    grads = _flat(jax_grads)
    for path, want in _flat(expected_params).items():
        conditioned = np.abs(grads[path]) >= 10 * ADAM_EPS
        np.testing.assert_allclose(ours[path][conditioned], want[conditioned], rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(path))
        np.testing.assert_allclose(ours[path][~conditioned], want[~conditioned], rtol=0,
                                   atol=NEAR_ZERO_STEP_TOL, err_msg=str(path))
