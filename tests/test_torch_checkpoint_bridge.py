"""The checkpoint bridge, ``scripts/convert_checkpoint.py``, held against
both packages on the CPU.

A checkpoint that the JAX CLI trained, converted into the port's layout,
generates in the port's CLI the greedy MIDI the JAX CLI generates from the
original, byte for byte, evaluates to the same loss, and resumes training
where the JAX run left it: one further step in each package from the same
state and batch gives the Trainer tolerances of
``tests/test_torch_trainer.py``. The other direction holds too, and a round
trip returns the checkpoint bit for bit. Each package trains once (the
module-scoped ``runs``).
"""

from __future__ import annotations

import importlib.util
import shutil
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

import composer_tpu.cli as jax_cli
import composer_tpu.train.trainer as jax_trainer_module
import composer_tpu_torch.cli as port_cli
import composer_tpu_torch.train.trainer as port_trainer_module
from composer_tpu.config import get as jax_config
from composer_tpu.midi import Note, NoteSequence, SustainPeriod
from composer_tpu.models import ModelType as JaxModelType
from composer_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from composer_tpu.train.checkpoint import abstract_like
from composer_tpu_torch.models.convert import find_adam_state, params_to_flax
from composer_tpu_torch.train.checkpoint import CheckpointManager as PortCheckpoints

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = 2e-6  # tests/test_torch_trainer.py: losses, relative
PARAM_ATOL = 5e-6  # and weights, absolute
EVAL_TOL = 2e-6  # evaluate's loss and accuracy, relative

# tests/test_cli.py's tiny config, with warmup and clipping on so that the
# bridge meets optax's chained state (clip, then Adam with a schedule), and
# the learning rate of tests/test_torch_trainer.py, 1e-3: the key bias's
# gradient is 0 but for rounding, and Adam scales that noise up to the
# learning rate, so at 1e-2 the resumed step left it 3.6e-5 apart between
# the packages (3.7e-9 at 1e-3, the largest of any weight).
TINY_CONFIG = """
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
        lstm_layers_count: 1
        lstm_layer_sizes: 16
        lstm_dropout_probability: 0.0
        use_batch_normalization: true
    train: {batch_size: 2, learning_rate: 0.01}
transformer:
    model:
        window_size: 16
        embedding_size: 16
        decoder_layers_count: 1
        attention_head_count: 2
        use_relative_attention: true
        attention_dropout_rate: 0.0
        residual_dropout_rate: 0.0
        layer_normalization_epsilon: 0.00001
        scale_attention: true
        initializer_mean: 0
        initializer_stddev: 0.02
        use_layer_normalization: true
    train: {batch_size: 2, learning_rate: 0.001, warmup_steps: 4, gradient_clip_norm: 1.0}
"""


def _bridge():
    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint", REPO / "scripts" / "convert_checkpoint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(cli, *args):
    result = CliRunner().invoke(cli, [str(a) for a in args], catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result


def port(*args):
    return run(port_cli.cli, "--seed", 9, "--device", "cpu", *args)


def jax_run(*args):
    return run(jax_cli.cli, "--seed", 9, *args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages train one epoch on the same preprocessed corpus; each
    logdir is bridged into the other package's layout."""
    root = tmp_path_factory.mktemp("bridge")
    config = root / "config.yml"
    config.write_text(TINY_CONFIG)
    raw = root / "raw"
    raw.mkdir()
    rng = np.random.default_rng(5)
    for index in range(3):
        t, notes = 0.0, []
        for _ in range(60):
            duration = float(rng.integers(80, 500))
            notes.append(Note(t, t + duration, int(rng.integers(40, 90)),
                              int(rng.integers(20, 120))))
            t += float(rng.integers(40, 250))
        NoteSequence(notes, [SustainPeriod(0, t / 4)]).to_midi(str(raw / f"p{index}.mid"))
    processed = root / "processed"
    jax_run("preprocess", "transformer", raw, processed, "-c", config, "-w", 1,
            "--no-transform")
    common = ("-c", config, "-e", 1, "--save-freq-mode", "epoch", "--no-show-progress-bar",
              "--no-data-parallel")
    jax_run("train", "transformer", processed, "--logdir", root / "jax_logs", *common)
    port("train", "transformer", processed, "--logdir", root / "port_logs", *common)
    jax_logdir = next((root / "jax_logs").glob("transformer-*"))
    port_logdir = next((root / "port_logs").glob("transformer-*"))
    bridge = _bridge()
    bridge.to_torch(jax_logdir, root / "jax_as_port")
    bridge.to_jax(port_logdir, root / "port_as_jax")
    return {"root": root, "raw": raw, "processed": processed, "bridge": bridge,
            "jax": jax_logdir, "port": port_logdir, "jax_as_port": root / "jax_as_port",
            "port_as_jax": root / "port_as_jax"}


def _jax_state(logdir):
    config = jax_config(Path(logdir) / "config.yml")
    trainer = jax_cli._make_trainer(JaxModelType.TRANSFORMER, config)
    return trainer, trainer.restore(logdir, 2, 16)


def _port_state(logdir):
    from composer_tpu_torch.config import get as port_config
    from composer_tpu_torch.models import ModelType, create_model
    from composer_tpu_torch.train.trainer import Trainer

    config = port_config(Path(logdir) / "config.yml")
    model, _ = create_model(ModelType.TRANSFORMER, config, device="cpu")
    trainer = Trainer(model, ModelType.TRANSFORMER, 0.001, warmup_steps=4,
                      gradient_clip_norm=1.0, device="cpu")
    return trainer, trainer.restore(logdir, 2, 16)


def _generated(cli_run, logdir, out, prompt):
    args = ["generate", "transformer", logdir, out, "-l", 24, "--temperature", 0]
    if prompt is not None:
        args += ["-p", prompt, "--prompt-length", 4]
    cli_run(*args)
    return Path(out).read_bytes()


@pytest.mark.parametrize("with_prompt", [True, False])
def test_jax_checkpoint_generates_the_same_greedy_midi_in_the_port(runs, with_prompt):
    prompt = runs["raw"] / "p0.mid" if with_prompt else None
    root = runs["root"]
    expected = _generated(jax_run, runs["jax"], root / f"jax_{with_prompt}.mid", prompt)
    got = _generated(port, runs["jax_as_port"], root / f"port_{with_prompt}.mid", prompt)
    assert got == expected


def test_port_checkpoint_generates_the_same_greedy_midi_in_jax(runs):
    root = runs["root"]
    expected = _generated(port, runs["port"], root / "from_port.mid", runs["raw"] / "p1.mid")
    got = _generated(jax_run, runs["port_as_jax"], root / "in_jax.mid", runs["raw"] / "p1.mid")
    assert got == expected


def test_bridged_checkpoint_evaluates_like_the_original(runs, monkeypatch):
    """``evaluate`` in both CLIs, each reading its own package's checkpoint
    of the same weights: loss and accuracy within 2e-6."""
    results = {}
    for name, module in (("jax", jax_trainer_module), ("port", port_trainer_module)):
        real = module.Trainer.evaluate

        def spy(self, *args, _real=real, _name=name, **kwargs):
            results[_name] = _real(self, *args, **kwargs)
            return results[_name]

        monkeypatch.setattr(module.Trainer, "evaluate", spy)
    jax_run("evaluate", "transformer", runs["processed"], runs["jax"])
    port("evaluate", "transformer", runs["processed"], runs["jax_as_port"])
    for key in ("loss", "accuracy", "perplexity"):
        np.testing.assert_allclose(results["port"][key], results["jax"][key], rtol=EVAL_TOL,
                                   err_msg=key)


def test_bridged_checkpoint_resumes_one_step_like_jax(runs):
    """One further step from the bridged state, in each package, on the
    same batch (dropout 0): losses within 2e-6, weights within 5e-6, and
    the counters carried over."""
    jax_trainer, jax_state = _jax_state(runs["jax"])
    port_trainer, port_state = _port_state(runs["jax_as_port"])
    assert (port_state.step, port_state.epoch) == (int(jax_state.step), int(jax_state.epoch))
    assert port_state.optimizer.count == int(find_adam_state(
        flax.serialization.to_state_dict(jax_state.opt_state))["count"])
    batch = np.random.default_rng(3).integers(0, 390, (2, 17)).astype(np.int32)
    x, y = batch[:, :-1], batch[:, 1:]
    jax_state, jax_metrics, _ = jax_trainer.train_step(
        jax_state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0), None)
    port_metrics = port_trainer.train_step(port_state, x, y, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(port_metrics["loss"]), float(jax_metrics["loss"]),
                               rtol=LOSS_TOL)
    got = params_to_flax(port_state.model.state_dict(), port_state.model.config)
    expected = jax.device_get(jax_state.params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(expected)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, leaf, rtol=0, atol=PARAM_ATOL, err_msg=str(path))


def test_bridged_checkpoint_resumes_in_the_port_cli(runs, tmp_path):
    """``train --restoredir`` on the bridged logdir carries the step and
    epoch counters on: one more epoch ends at twice the first's steps."""
    logdir = tmp_path / "resumed"
    shutil.copytree(runs["jax_as_port"], logdir)
    first = PortCheckpoints(logdir).latest_step()
    port("train", "transformer", runs["processed"], "--restoredir", logdir, "-e", 2,
         "--save-freq-mode", "epoch", "--no-show-progress-bar")
    restored = PortCheckpoints(logdir).restore(map_location="cpu")
    assert (int(restored["step"]), int(restored["epoch"])) == (2 * first + 1, 3)
    assert restored["opt_state"]["count"] == 2 * first


def test_round_trip_returns_the_checkpoint_bit_for_bit(runs, tmp_path):
    """JAX -> port -> JAX: params, Adam count and moments, the schedule's
    count, step and epoch all equal the original's."""
    runs["bridge"].to_jax(runs["jax_as_port"], tmp_path / "back")
    template = flax.serialization.to_state_dict(_jax_state(runs["jax"])[1])
    states = []
    for logdir in (runs["jax"], tmp_path / "back"):
        manager = JaxCheckpoints(logdir)
        states.append(jax.device_get(manager.restore(abstract_like(template))))
        manager.close()
    original, back = states
    leaves = jax.tree_util.tree_flatten_with_path(original)[0]
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for (path, a), b in zip(leaves, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(path))
