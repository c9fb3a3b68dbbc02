"""The port's MusicRNN, its Trainer path and its weight bridge against the
JAX package (f32, CPU).

Both packages start from the same weights (the JAX ``init`` carried over by
``rnn_params_from_flax``) and see the same numpy inputs: vocab 30, embed 16,
two LSTM layers of 24, window 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composer_tpu.data.loader import WindowDataset as JaxWindowDataset
from composer_tpu.models import ModelType as JaxModelType
from composer_tpu.models.music_rnn import MusicRNN as JaxMusicRNN
from composer_tpu.models.music_rnn import MusicRNNConfig as JaxConfig
from composer_tpu.train.trainer import Trainer as JaxTrainer
from composer_tpu_torch.data import WindowDataset
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.convert import (
    adam_state_from_optax,
    adam_state_to_optax,
    rnn_params_from_flax,
    rnn_params_to_flax,
)
from composer_tpu_torch.models.music_rnn import MusicRNN, MusicRNNConfig, init_state
from composer_tpu_torch.train.trainer import Trainer

VOCAB, EMBED, SIZES, WINDOW, BATCH = 30, 16, (24, 24), 16, 4
LR = 1e-2
# f32 sums in other orders: logits and carries agree to a few 1e-7 of their
# scale; 1e-5 of scale is the bound held.
FORWARD_TOL = 1e-5
# After 3 Adam steps at lr 1e-2 the weights agree to about 1e-7; a doubled
# bias or a wrong BatchNorm statistic moves them by about lr.
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5


def _configs(batch_norm=True, dropout=0.0):
    common = dict(vocab_size=VOCAB, embed_dim=EMBED, layer_sizes=SIZES,
                  dropout_rates=(dropout,) * len(SIZES), use_batch_normalization=batch_norm)
    return JaxConfig(**common), MusicRNNConfig(**common)


def _jax_variables(config, seed=0):
    """JAX init with non-trivial running statistics (the init's are 0 and 1)."""
    variables = jax.device_get(JaxMusicRNN(config).init_variables(
        jax.random.PRNGKey(seed), BATCH, WINDOW))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed + 100)
    for stats in variables.get("batch_stats", {}).values():
        stats["mean"] = rng.normal(0, 0.1, stats["mean"].shape).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, stats["var"].shape).astype(np.float32)
    return variables


def _port_model(config, variables):
    model = MusicRNN(config)
    model.load_state_dict(rnn_params_from_flax(
        variables["params"], variables.get("batch_stats"), config))
    return model


def _tokens(seed, batch=BATCH, length=WINDOW):
    return np.random.default_rng(seed).integers(0, VOCAB, (batch, length)).astype(np.int32)


def _carry(seed):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(0, 0.5, (BATCH, h)).astype(np.float32),
                  rng.normal(0, 0.5, (BATCH, h)).astype(np.float32)) for h in SIZES)


def _close(got, expected, tol, name):
    expected = np.asarray(expected)
    scale = max(float(np.abs(expected).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), expected, rtol=0, atol=tol * scale,
                               err_msg=name)


def _torch_carry(carry):
    return tuple((torch.from_numpy(c), torch.from_numpy(h)) for c, h in carry)


@pytest.mark.parametrize("batch_norm", [True, False])
@pytest.mark.parametrize("start", ["zeros", "nonzero"])
def test_forward_matches_jax(batch_norm, start):
    """Logits and carries over two chained calls (the carry threaded), from
    zero or from a non-zero initial carry, in eval mode."""
    jax_config, config = _configs(batch_norm)
    variables = _jax_variables(jax_config)
    jax_model, model = JaxMusicRNN(jax_config), _port_model(config, variables)
    carry = None if start == "zeros" else _carry(7)
    jax_carry = None if carry is None else jax.tree_util.tree_map(jnp.asarray, carry)
    port_carry = None if carry is None else _torch_carry(carry)
    for call in range(2):
        tokens = _tokens(call)
        jax_logits, jax_carry = jax_model.apply(variables, jnp.asarray(tokens), jax_carry)
        with torch.no_grad():
            logits, port_carry = model(torch.from_numpy(tokens).long(), port_carry)
        _close(logits.numpy(), jax_logits, FORWARD_TOL, f"logits, call {call}")
        for layer, ((c, h), (jc, jh)) in enumerate(zip(port_carry, jax_carry)):
            _close(c.numpy(), jc, FORWARD_TOL, f"c {layer}, call {call}")
            _close(h.numpy(), jh, FORWARD_TOL, f"h {layer}, call {call}")


def test_init_state_and_parameter_layout():
    _, config = _configs()
    state = init_state(config, 3)
    assert [(c.shape, h.shape) for c, h in state] == [((3, 24), (3, 24))] * 2
    assert all(c.dtype == torch.float32 and not c.any() for pair in state for c in pair)
    bf16 = init_state(MusicRNNConfig(VOCAB, layer_sizes=(8,), dtype=torch.bfloat16), 2)
    assert bf16[0][0].dtype == torch.bfloat16
    model = MusicRNN(config)
    # One trainable bias a gate, as Flax: no parameter of torch's second bias.
    assert [name for name, _ in model.named_parameters()] == [
        "embedding.weight",
        "lstm_0.weight_ih", "lstm_0.weight_hh", "lstm_0.bias",
        "batch_norm_0.weight", "batch_norm_0.bias",
        "lstm_1.weight_ih", "lstm_1.weight_hh", "lstm_1.bias",
        "batch_norm_1.weight", "batch_norm_1.bias",
        "output.weight", "output.bias"]
    assert [name for name, _ in model.named_buffers()] == [
        "batch_norm_0.running_mean", "batch_norm_0.running_var",
        "batch_norm_1.running_mean", "batch_norm_1.running_var"]


def test_reset_parameters_follows_the_flax_initializers():
    """Per-gate Glorot bounds (the fan of each gate's own matrix), zero
    biases, unit scales, running statistics 0 and 1; one seed, one model."""
    _, config = _configs()
    model = MusicRNN(config)
    model.reset_parameters(torch.Generator().manual_seed(3))
    again = MusicRNN(config)
    again.reset_parameters(torch.Generator().manual_seed(3))
    for name, tensor in model.state_dict().items():
        assert torch.equal(tensor, again.state_dict()[name]), name
    for lstm, fan_in in zip(model.lstm_layers, (EMBED, SIZES[0])):
        for weight, fan in ((lstm.weight_ih, fan_in), (lstm.weight_hh, SIZES[0])):
            bound = (6.0 / (fan + SIZES[0])) ** 0.5
            largest = float(weight.detach().abs().max())
            assert 0.9 * bound < largest <= bound
        assert not lstm.bias.any()
    for norm in model.batch_norms:
        assert torch.equal(norm.weight, torch.ones(24)) and not norm.bias.any()
        assert not norm.running_mean.any() and torch.equal(norm.running_var, torch.ones(24))
    assert not model.output.bias.any()
    assert abs(float(model.embedding.weight.std()) - EMBED ** -0.5) < 0.05


def test_training_forward_batch_norm_statistics_match_jax():
    """A training-mode forward (dropout 0) normalises with the batch's own
    statistics and updates the running ones with the biased variance, as
    Flax does (momentum 0.99)."""
    jax_config, config = _configs()
    variables = _jax_variables(jax_config)
    model = _port_model(config, variables)
    tokens = _tokens(3)
    (jax_logits, _), updates = JaxMusicRNN(jax_config).apply(
        variables, jnp.asarray(tokens), None, deterministic=False, mutable=["batch_stats"])
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(tokens).long(), deterministic=False)
    _close(logits.numpy(), jax_logits, FORWARD_TOL, "logits")
    _, stats = rnn_params_to_flax(model.state_dict(), config)
    for layer, expected in jax.device_get(updates["batch_stats"]).items():
        for key in ("mean", "var"):
            # The update itself (new - old), held to its own scale: the
            # unbiased variance would move it by 1 / (B T - 1) of itself.
            old = variables["batch_stats"][layer][key]
            _close(stats[layer][key] - old, expected[key] - old, FORWARD_TOL,
                   f"{layer} {key}")
            assert not np.array_equal(stats[layer][key], old)


def _stream(steps, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, steps * BATCH * (WINDOW + 1))


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_trainer_tracks_jax_trainer_over_three_steps():
    """Loss, parameters, Adam moments, BatchNorm statistics and the carry
    after 3 train steps with the carry threaded through, dropout 0. Two
    trainable biases would each take an Adam step and drift by about lr."""
    jax_config, config = _configs()
    jax_trainer = JaxTrainer(JaxMusicRNN(jax_config), JaxModelType.MUSIC_RNN, LR)
    jax_state = jax_trainer.init_state(BATCH, WINDOW)
    init = jax.device_get({"params": jax_state.params, **jax_state.extra_vars})
    trainer = Trainer(MusicRNN(config), ModelType.MUSIC_RNN, LR, device="cpu")
    state = trainer.init_state(BATCH, WINDOW)
    state.model.load_state_dict(rnn_params_from_flax(init["params"], init["batch_stats"],
                                                     config))

    jax_carry, carry = jax_trainer.init_rnn_carry(BATCH), trainer.init_rnn_carry(BATCH)
    jax_losses, losses = [], []
    for x, y in JaxWindowDataset(_stream(3), BATCH, WINDOW, shuffle=False):
        jax_state, metrics, jax_carry = jax_trainer.train_step(
            jax_state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0), jax_carry)
        jax_losses.append(float(metrics["loss"]))
    for x, y in WindowDataset(_stream(3), BATCH, WINDOW, shuffle=False):
        metrics = trainer.train_step(state, x, y, carry=carry)
        carry = metrics["carry"]
        assert all(not c.requires_grad and not h.requires_grad for c, h in carry)
        losses.append(float(metrics["loss"]))

    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    assert state.step == 4 and state.optimizer.count == 3
    params, stats = rnn_params_to_flax(state.model.state_dict(), config)
    for name, expected in _flat(jax.device_get(jax_state.params)).items():
        np.testing.assert_allclose(_flat(params)[name], expected, rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
    for name, expected in _flat(jax.device_get(jax_state.extra_vars["batch_stats"])).items():
        np.testing.assert_allclose(_flat(stats)[name], expected, rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
    names = [name for name, _ in state.model.named_parameters()]
    adam = adam_state_to_optax(state.optimizer.state_dict(), config, names)
    jax_adam = jax.device_get(jax_state.opt_state[0])
    for moment in ("mu", "nu"):
        expected_tree = _flat(getattr(jax_adam, moment))
        scale = max(float(np.abs(v).max()) for v in expected_tree.values())
        for name, expected in expected_tree.items():
            np.testing.assert_allclose(_flat(adam[moment])[name], expected, rtol=0,
                                       atol=PARAM_ATOL * scale, err_msg=f"{moment} {name}")
    for (c, h), (jc, jh) in zip(carry, jax_carry):
        _close(c.numpy(), jc, FORWARD_TOL, "c")
        _close(h.numpy(), jh, FORWARD_TOL, "h")


def test_train_resets_the_carry_each_epoch_unless_asked_not_to(tmp_path):
    """``reset_rnn_state_each_epoch``: each epoch's first step starts from
    zeros, or with False from the last step's carry."""
    _, config = _configs()
    for reset in (True, False):
        trainer = Trainer(MusicRNN(config), ModelType.MUSIC_RNN, LR, device="cpu")
        state = trainer.init_state(BATCH, WINDOW)
        calls = []
        step = trainer.train_step

        def recording(state, x, y, generator=None, carry=None):
            calls.append(carry)
            return step(state, x, y, generator, carry)

        trainer.train_step = recording
        trainer.train(WindowDataset(_stream(2), BATCH, WINDOW, shuffle=False), state,
                      tmp_path / str(reset), epochs=2, show_progress_bar=False,
                      reset_rnn_state_each_epoch=reset)
        assert len(calls) == 4
        # The epoch's first step starts from zeros exactly when reset.
        assert (not any(t.any() for pair in calls[2] for t in pair)) == reset
        assert not any(t.any() for pair in calls[0] for t in pair)
        assert all(t.any() for pair in calls[1] for t in pair)


def test_evaluate_matches_jax():
    """Mean loss (BASELINE's NLL surface) and accuracy over a short dataset,
    one carry threaded through every batch in dataset order."""
    jax_config, config = _configs()
    variables = _jax_variables(jax_config, seed=2)
    jax_trainer = JaxTrainer(JaxMusicRNN(jax_config), JaxModelType.MUSIC_RNN, LR)
    jax_state = jax_trainer.init_state(BATCH, WINDOW).replace(
        params=variables["params"], extra_vars={"batch_stats": variables["batch_stats"]})
    expected = jax_trainer.evaluate(JaxWindowDataset(_stream(5, 4), BATCH, WINDOW,
                                                     shuffle=False), jax_state)
    trainer = Trainer(MusicRNN(config), ModelType.MUSIC_RNN, LR, device="cpu")
    state = trainer.init_state(BATCH, WINDOW)
    state.model.load_state_dict(rnn_params_from_flax(variables["params"],
                                                     variables["batch_stats"], config))
    got = trainer.evaluate(WindowDataset(_stream(5, 4), BATCH, WINDOW, shuffle=False), state)
    np.testing.assert_allclose(got["loss"], expected["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["perplexity"], expected["perplexity"], rtol=LOSS_RTOL)
    assert abs(got["accuracy"] - expected["accuracy"]) < 1e-6
    # The carry matters: batches evaluated each from zeros score otherwise.
    fresh = [trainer.eval_step(state, x, y)["loss"] for x, y in
             WindowDataset(_stream(5, 4), BATCH, WINDOW, shuffle=False)]
    assert abs(float(torch.stack(fresh).mean()) - got["loss"]) > 1e-4


def test_dropout_keeps_the_mean_and_follows_its_generator():
    """Dropout 0.3 before the head (no BatchNorm, so the logits are linear
    in the dropped activations): over 400 copies of one sequence, each with
    masks of its own, the mean is the eval-mode forward; one seed gives one
    mask, two seeds two."""
    config = MusicRNNConfig(VOCAB, EMBED, (24,), (0.3,), use_batch_normalization=False)
    model = MusicRNN(config)
    model.reset_parameters(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens(5, batch=1)).long().expand(400, -1)
    with torch.no_grad():
        expected, _ = model(tokens[:1])

        def draw(seed):
            return model(tokens, deterministic=False,
                         generator=torch.Generator().manual_seed(seed))[0]

        first = draw(1)
        assert torch.equal(first, draw(1))
        assert not torch.equal(first, draw(2))
        assert not torch.equal(first[0], first[1])  # each row its own mask
    bias = model.output.bias
    error = (first.mean(0) - expected[0]).abs().max() / (expected - bias).abs().max()
    assert float(error) < 0.1


def test_bridge_round_trips_bit_for_bit():
    """Flax -> port -> Flax and port -> Flax -> port are exact, weights,
    running statistics and Adam moments."""
    jax_config, config = _configs()
    variables = _jax_variables(jax_config, seed=4)
    state = rnn_params_from_flax(variables["params"], variables["batch_stats"], config)
    params, stats = rnn_params_to_flax(state, config)
    assert _flat(params).keys() == _flat(variables["params"]).keys()
    for name, value in _flat(variables["params"]).items():
        assert np.array_equal(_flat(params)[name], value), name
    for name, value in _flat(variables["batch_stats"]).items():
        assert np.array_equal(_flat(stats)[name], value), name

    model = MusicRNN(config)
    model.reset_parameters(torch.Generator().manual_seed(9))
    back = rnn_params_from_flax(*rnn_params_to_flax(model.state_dict(), config), config)
    assert list(back) == list(model.state_dict())
    for name, tensor in model.state_dict().items():
        assert torch.equal(back[name], tensor), name

    names = [name for name, _ in model.named_parameters()]
    moments = {"count": 3, "mu": [torch.randn_like(p) for p in model.parameters()],
               "nu": [torch.rand_like(p) for p in model.parameters()]}
    again = adam_state_from_optax(adam_state_to_optax(moments, config, names), config, names)
    assert again["count"] == 3
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(again[key], moments[key]))


def test_create_model_music_rnn_from_the_default_config():
    from composer_tpu_torch.config import get_default
    from composer_tpu_torch.models import create_model

    model, vocab = create_model(ModelType.MUSIC_RNN, get_default(), device="cpu")
    config = model.config
    assert (vocab, config.embed_dim, config.layer_sizes) == (390, 256, (512, 512, 512))
    assert config.dropout_rates == (0.3, 0.3, 0.3) and config.use_batch_normalization
    assert config.dtype == torch.float32  # CPU stays float32
    assert next(model.parameters()).device.type == "cpu"


BRIDGE_CONFIG = """
dataset:
    time_step_increment: 10
    max_time_steps: 100
    velocity_bins: 32
    time_stretch_range: {start: 0.90, stop: 1.10}
    pitch_shift_range: {start: -4, stop: 4}
    trim_start: true
music_rnn:
    model:
        window_size: 16
        embedding_size: 16
        lstm_layers_count: 2
        lstm_layer_sizes: 24
        lstm_dropout_probability: 0.0
        use_batch_normalization: true
    train: {batch_size: 2, learning_rate: 0.01}
transformer:
    model:
        window_size: 16
        embedding_size: 16
        decoder_layers_count: 1
        attention_head_count: 2
        use_relative_attention: false
        attention_dropout_rate: 0.0
        residual_dropout_rate: 0.0
        layer_normalization_epsilon: 0.00001
        scale_attention: true
        initializer_mean: 0
        initializer_stddev: 0.02
        use_layer_normalization: true
    train: {batch_size: 2, learning_rate: 0.01}
"""


def test_checkpoint_script_converts_music_rnn_both_ways(tmp_path):
    """``scripts/convert_checkpoint.py --model-type music_rnn``: a JAX
    logdir after 2 steps restores in the port with its weights, running
    statistics, Adam moments and counters, and converts back bit for bit."""
    import importlib.util
    from pathlib import Path

    import flax

    from composer_tpu.config import get as jax_get_config
    from composer_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
    from composer_tpu.train.checkpoint import abstract_like
    from composer_tpu_torch.config import get as port_get_config
    from composer_tpu_torch.models import create_model

    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint", Path(__file__).resolve().parents[1] / "scripts"
        / "convert_checkpoint.py")
    bridge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bridge)

    source = tmp_path / "jax"
    source.mkdir()
    (source / "config.yml").write_text(BRIDGE_CONFIG)
    jax_trainer = bridge._jax_trainer(jax_get_config(source / "config.yml"), "music_rnn")
    state = jax_trainer.init_state(2, WINDOW)
    carry = jax_trainer.init_rnn_carry(2)
    stream = np.random.default_rng(6).integers(0, 390, 2 * 2 * (WINDOW + 1))
    for x, y in JaxWindowDataset(stream, 2, WINDOW, shuffle=False):
        state, _, carry = jax_trainer.train_step(state, jnp.asarray(x), jnp.asarray(y),
                                                 jax.random.PRNGKey(0), carry)
    manager = JaxCheckpoints(source)
    manager.save(2, flax.serialization.to_state_dict(state), wait=True)
    manager.close()
    assert bridge.main(["to-torch", str(source), str(tmp_path / "port"),
                        "--model-type", "music_rnn"]) == 0

    config = port_get_config(tmp_path / "port" / "config.yml")
    model, _ = create_model(ModelType.MUSIC_RNN, config, device="cpu")
    restored = Trainer(model, ModelType.MUSIC_RNN, 0.01, device="cpu").restore(
        tmp_path / "port", 2, WINDOW)
    assert (restored.step, restored.epoch, restored.optimizer.count) == (3, 1, 2)
    params, stats = rnn_params_to_flax(model.state_dict(), model.config)
    original = jax.device_get(state)
    for tree, expected in ((params, original.params),
                           (stats, original.extra_vars["batch_stats"])):
        for name, value in _flat(expected).items():
            assert np.array_equal(_flat(tree)[name], value), name

    assert bridge.main(["to-jax", str(tmp_path / "port"), str(tmp_path / "back"),
                        "--model-type", "music_rnn"]) == 0
    template = flax.serialization.to_state_dict(state)
    manager = JaxCheckpoints(tmp_path / "back")
    back = jax.device_get(manager.restore(abstract_like(template)))
    manager.close()
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(template))[0]
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for (path, a), b in zip(leaves, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(path))
