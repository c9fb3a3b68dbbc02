"""The PyTorch port's Trainer, optimizer and checkpoints against the JAX
package (f32, CPU).

The JAX Trainer runs the Transformer with ``use_pallas_attention`` through
its Pallas flash kernels in interpret mode; the port's runs the same model
through ``ops/flash_attention.py``, whose wrappers take the plain version on
CPU tensors. Both start from the same parameters (``params_from_flax``) and
see the same numpy batches, dropout 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from composer_tpu.data.loader import WindowDataset as JaxWindowDataset
from composer_tpu.models import ModelType as JaxModelType
from composer_tpu.models.transformer import Transformer as JaxTransformer
from composer_tpu.models.transformer import TransformerConfig as JaxConfig
from composer_tpu.train.trainer import Trainer as JaxTrainer
from composer_tpu.train.trainer import make_optimizer as jax_make_optimizer
from composer_tpu_torch import ModelSaveFrequencyMode
from composer_tpu_torch.data import WindowDataset
from composer_tpu_torch.exceptions import CheckpointError
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.convert import params_from_flax, params_to_flax
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.train.checkpoint import CheckpointManager
from composer_tpu_torch.train.trainer import Trainer, make_optimizer

VOCAB, WINDOW, BATCH, STEPS = 64, 128, 2, 12
LR = 1e-3
# f32 sums in different orders: the losses agreed to 2.3e-7 relative and
# the weights to 1.2e-7 after 12 steps when this test was written (a
# gradient near 0 whose sign differed between the frameworks would show as
# a weight off by up to lr; none does on these batches).
LOSS_TOL = 2e-6
PARAM_ATOL = 5e-6


def _kwargs(use_pallas=True, dropout=0.0):
    return dict(vocab_size=VOCAB, embed_dim=32, window_size=WINDOW, num_layers=2, num_heads=2,
                use_relative_attention=True, attention_dropout_rate=dropout,
                residual_dropout_rate=dropout, use_pallas_attention=use_pallas)


def _stream(steps=STEPS, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, steps * BATCH * (WINDOW + 1))


def _port_trainer(**kwargs):
    config = TransformerConfig(**_kwargs())
    return Trainer(Transformer(config), ModelType.TRANSFORMER, LR, device="cpu", **kwargs)


def _jax_state(**kwargs):
    trainer = JaxTrainer(JaxTransformer(JaxConfig(**_kwargs())), JaxModelType.TRANSFORMER,
                         LR, **kwargs)
    return trainer, trainer.init_state(BATCH, WINDOW)


def _flat(params):
    return {k: np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Trainer's losses and final params over STEPS batches, with
    warmup and clipping, from its own init (returned too)."""
    trainer, state = _jax_state(warmup_steps=3, gradient_clip_norm=1.0)
    init = jax.device_get(state.params)
    dataset = JaxWindowDataset(_stream(), BATCH, WINDOW, shuffle=False)
    rng = jax.random.PRNGKey(0)
    losses = []
    for x, y in dataset:
        state, metrics, _ = trainer.train_step(state, jnp.asarray(x), jnp.asarray(y), rng, None)
        losses.append(float(metrics["loss"]))
    return init, losses, jax.device_get(state.params)


def test_trainer_tracks_jax_trainer(jax_run):
    init, jax_losses, jax_params = jax_run
    trainer = _port_trainer(warmup_steps=3, gradient_clip_norm=1.0)
    state = trainer.init_state(BATCH, WINDOW)
    state.model.load_state_dict(params_from_flax(init, state.model.config))
    losses = [float(trainer.train_step(state, x, y)["loss"])
              for x, y in WindowDataset(_stream(), BATCH, WINDOW, shuffle=False)]
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_TOL)
    assert losses[-1] < losses[0]
    assert state.step == STEPS + 1
    ours = params_to_flax(state.model.state_dict(), state.model.config)
    for (path, expected), (_, got) in zip(_flat(jax_params).items(), _flat(ours).items()):
        np.testing.assert_allclose(got, expected, rtol=0, atol=PARAM_ATOL, err_msg=str(path))


def test_training_forward_matches_jax_with_dropout_zero():
    """``deterministic=False`` at dropout 0 equals the JAX training forward."""
    jax_model = JaxTransformer(JaxConfig(**_kwargs()))
    params = jax.device_get(jax_model.init_params(jax.random.PRNGKey(1), 1, WINDOW))
    model = Transformer(TransformerConfig(**_kwargs()))
    model.load_state_dict(params_from_flax(params, model.config))
    tokens = np.random.default_rng(2).integers(0, VOCAB, (BATCH, WINDOW)).astype(np.int32)
    expected, _ = jax_model.apply({"params": params}, jnp.asarray(tokens), deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
    logits, _ = model(torch.as_tensor(tokens).long(), deterministic=False,
                      generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(expected),
                               rtol=2e-4, atol=2e-4)


def test_dropout_changes_the_training_forward_only():
    model = Transformer(TransformerConfig(**_kwargs(dropout=0.1)))
    model.reset_parameters(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, VOCAB, (BATCH, WINDOW)))
    eval_a, _ = model(tokens)
    eval_b, _ = model(tokens)
    train_a, _ = model(tokens, deterministic=False, generator=torch.Generator().manual_seed(5))
    train_b, _ = model(tokens, deterministic=False, generator=torch.Generator().manual_seed(5))
    train_c, _ = model(tokens, deterministic=False, generator=torch.Generator().manual_seed(6))
    assert torch.equal(eval_a, eval_b) and torch.equal(train_a, train_b)
    assert not torch.allclose(train_a, eval_a) and not torch.allclose(train_a, train_c)


@pytest.mark.parametrize("warmup,clip", [(0, 0.0), (4, 0.0), (0, 1.0), (4, 1.0)])
def test_make_optimizer_matches_optax(warmup, clip):
    """Adam (eps 1e-7), linear warmup from lr 0 and global-norm clipping on
    fixed numpy gradients, against optax, over 6 updates. The gradients of
    the clipped cases sit above and below the clip norm. Same operations in
    the same order; the two frameworks' kernels may still round a fused
    multiply-add differently, hence 1e-6 on weights of size about 1."""
    rng = np.random.default_rng(4)
    init = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * (0.2 if i % 2 else 3.0)).astype(np.float32)
              for k, v in init.items()} for i in range(6)]

    jax_opt = jax_make_optimizer(0.1, warmup_steps=warmup, gradient_clip_norm=clip)
    jax_params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = jax_opt.init(jax_params)
    spec = make_optimizer(0.1, warmup_steps=warmup, gradient_clip_norm=clip)
    params = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    adam = spec.init(params.values())
    for count, grad in enumerate(grads):
        updates, opt_state = jax_opt.update({k: jnp.asarray(g) for k, g in grad.items()},
                                            opt_state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for name, p in params.items():
            p.grad = torch.tensor(grad[name])
        adam.step()
        if count == 0 and warmup:
            assert all(torch.equal(p.detach(), torch.tensor(init[k])) for k, p in params.items())
        for name, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_params[name]),
                                       rtol=0, atol=1e-6)


def test_clip_scales_only_above_the_norm():
    spec = make_optimizer(0.1, gradient_clip_norm=1.0)
    small = [torch.full((4,), 0.25)]  # norm 0.5: untouched
    spec.clip_(small)
    assert torch.equal(small[0], torch.full((4,), 0.25))
    large = [torch.full((4,), 2.0)]  # norm 4: scaled to norm exactly 1
    spec.clip_(large)
    np.testing.assert_allclose(large[0].numpy(), 0.5, rtol=1e-7)


def test_evaluate_matches_jax_evaluate(jax_run):
    init, _, _ = jax_run
    trainer, jax_state = _jax_state()
    jax_state = jax_state.replace(params=jax.tree_util.tree_map(jnp.asarray, init))
    expected = trainer.evaluate(JaxWindowDataset(_stream(4, seed=9), BATCH, WINDOW,
                                                 shuffle=False), jax_state)
    port = _port_trainer()
    state = port.init_state(BATCH, WINDOW)
    state.model.load_state_dict(params_from_flax(init, state.model.config))
    got = port.evaluate(WindowDataset(_stream(4, seed=9), BATCH, WINDOW, shuffle=False), state)
    for key in ("loss", "accuracy", "perplexity"):
        np.testing.assert_allclose(got[key], expected[key], rtol=1e-5, err_msg=key)


def test_checkpoint_round_trip_and_retention(tmp_path):
    manager = CheckpointManager(tmp_path, max_to_keep=2)
    with pytest.raises(CheckpointError):
        manager.restore()
    for step in (3, 7, 11):
        manager.save(step, {"step": step, "w": torch.full((2,), float(step))})
    assert manager.steps() == [7, 11] and manager.latest_step() == 11
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["11", "7"]
    assert torch.equal(manager.restore()["w"], torch.full((2,), 11.0))
    assert manager.restore(step=7)["step"] == 7
    with pytest.raises(CheckpointError):
        manager.restore(step=3)


def test_train_loop_checkpoints_and_resumes(tmp_path):
    """``train`` with step-mode saves; a fresh Trainer restores the state,
    and a run resumed from a mid-run checkpoint follows the uninterrupted
    trajectory."""
    stream = _stream(6, seed=5)
    full = _port_trainer(warmup_steps=2)
    state = full.init_state(BATCH, WINDOW)
    state = full.train(WindowDataset(stream, BATCH, WINDOW, shuffle=False), state,
                       tmp_path / "full", epochs=2,
                       save_frequency_mode=ModelSaveFrequencyMode.GLOBAL_STEP,
                       save_frequency=6, max_checkpoints=3, show_progress_bar=False)
    assert state.step == 13 and state.epoch == 3
    assert CheckpointManager(tmp_path / "full").steps() == [6, 12]
    assert (tmp_path / "full" / "train" / "metrics.jsonl").exists()

    restored = _port_trainer(warmup_steps=2).restore(tmp_path / "full", BATCH, WINDOW)
    # The last save came at step 12 inside epoch 2, as in the JAX Trainer.
    assert (restored.step, restored.epoch) == (13, 2)
    for name, tensor in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[name], tensor), name

    # Resume from the checkpoint at step 6 (end of epoch 1).
    half = tmp_path / "half"
    CheckpointManager(half).save(6, CheckpointManager(tmp_path / "full").restore(step=6))
    resumed_trainer = _port_trainer(warmup_steps=2)
    resumed = resumed_trainer.restore(half, BATCH, WINDOW)
    resumed.epoch = 2  # the checkpoint was taken mid-run, before the epoch counter moved
    resumed = resumed_trainer.train(WindowDataset(stream, BATCH, WINDOW, shuffle=False),
                                    resumed, half, epochs=2, show_progress_bar=False)
    assert resumed.step == 13
    for name, tensor in state.model.state_dict().items():
        np.testing.assert_allclose(resumed.model.state_dict()[name].numpy(), tensor.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_unported_options_raise():
    """A mesh whose model degree does not divide the heads: the JAX package
    falls back to its band path there, the port refuses the mesh (ROADMAP
    Queue 3). No ranks are started."""
    from composer_tpu_torch.parallel import Mesh

    model = Transformer(TransformerConfig(**_kwargs()))
    mesh = Mesh(data=1, model=3, rank=0, data_index=0, model_index=0, ranks=(0, 1, 2),
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="heads 2 not divisible by model=3"):
        Trainer(model, ModelType.TRANSFORMER, LR, mesh=mesh, device="cpu")
