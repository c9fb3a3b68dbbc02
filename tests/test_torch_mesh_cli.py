"""The port's CLI on a mesh of CPU ranks.

``train --device cpu --model-parallel 2 --no-data-parallel`` runs as a
process of its own (it starts its second rank itself), in a session of its
own so that a hang kills both ranks; its checkpoint, evaluated on one
device, must give the loss of an in-process single-device ``Trainer``
after the same two steps on the same batches. ``serve --model-parallel 2
--continuous`` is a usage error, as in the JAX CLI.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from composer_tpu_torch import cli as port_cli
from composer_tpu_torch.config import get as get_config
from composer_tpu_torch.midi.events import Note, NoteSequence, SustainPeriod
from composer_tpu_torch.models import ModelType

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 120  # the bound on the train process, both ranks included
SEED = 9
LOSS_TOL = 1e-5

# tests/test_cli.py's tiny config (2 heads).
TINY_CONFIG = """
dataset:
    time_step_increment: 10
    max_time_steps: 100
    velocity_bins: 32
    time_stretch_range: {start: 0.90, stop: 1.10}
    pitch_shift_range: {start: -4, stop: 4}
    trim_start: true
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
    train: {batch_size: 2, learning_rate: 0.01}
"""


def invoke(*args):
    return CliRunner().invoke(port_cli.cli, [str(a) for a in args], catch_exceptions=False)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The tiny config and a corpus of two MIDI files of two notes each,
    preprocessed with a train/test split: two train batches."""
    root = tmp_path_factory.mktemp("mesh_cli")
    config = root / "config.yml"
    config.write_text(TINY_CONFIG)
    raw = root / "raw"
    raw.mkdir()
    rng = np.random.default_rng(5)
    for index in range(2):
        t, notes = 0.0, []
        for _ in range(2):
            duration = float(rng.integers(80, 500))
            notes.append(Note(t, t + duration, int(rng.integers(40, 90)),
                              int(rng.integers(20, 120))))
            t += float(rng.integers(40, 250))
        NoteSequence(notes, [SustainPeriod(0, t / 4)]).to_midi(str(raw / f"p{index}.mid"))
    data = root / "data"
    result = invoke("--seed", SEED, "preprocess", "transformer", raw, data, "-c", config,
                    "--split", "-w", 1)
    assert result.exit_code == 0, result.output
    return root, config, data


@pytest.fixture
def single_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(args, timeout):
    """The CLI as a process in its own session; on a timeout the session
    (both ranks) is killed."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    process = subprocess.Popen([sys.executable, "-m", "composer_tpu_torch.cli", *map(str, args)],
                               cwd=REPO, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        output = process.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(process.pid, signal.SIGKILL)
        process.communicate()
        raise
    return process.returncode, output


def _dataset(config, data, mode, monkeypatch):
    """``get_dataset`` as the CLI's train reaches it under ``--seed``."""
    monkeypatch.setattr(port_cli, "_GLOBAL_SEED", SEED)
    monkeypatch.setattr(port_cli, "_DEVICE", "cpu")
    np.random.seed(SEED)
    return port_cli.get_dataset(ModelType.TRANSFORMER, data, config, mode,
                                show_progress_bar=False)


def test_tensor_parallel_train_matches_one_device(workspace, tmp_path, monkeypatch,
                                                  single_thread):
    _, config_path, data = workspace
    code, output = _run(["--seed", SEED, "--device", "cpu", "train", "transformer", data,
                         "-c", config_path, "--logdir", tmp_path / "mesh", "-e", 1,
                         "--model-parallel", 2, "--no-data-parallel",
                         "--no-show-progress-bar"], DEADLINE_S)
    assert code == 0, output
    assert "Mesh: data=1 x model=2 over 2 ranks." in output
    (logdir,) = (tmp_path / "mesh").glob("transformer-*")
    assert sorted(p.name for p in (logdir / "checkpoints").iterdir()) == ["2"]

    config = get_config(config_path)
    dataset = _dataset(config, data, "train", monkeypatch)
    assert len(dataset) == 2
    trainer = port_cli._make_trainer(ModelType.TRANSFORMER, config)
    state = trainer.train(dataset, trainer.init_state(2, 16), tmp_path / "single", epochs=1,
                          show_progress_bar=False)
    assert state.step == 3

    # evaluate's path (restore, then Trainer.evaluate) on one device, over
    # the train split in order (the test split is shorter than a window).
    batches = _dataset(config, data, "train", monkeypatch)
    batches.shuffle = False
    restored = port_cli._make_trainer(ModelType.TRANSFORMER, config)
    mesh_scores = restored.evaluate(batches, restored.restore(logdir, 2, 16))
    single_scores = trainer.evaluate(batches, state)
    assert abs(mesh_scores["loss"] - single_scores["loss"]) <= LOSS_TOL * single_scores["loss"]


def test_serve_refuses_model_parallel_with_continuous(tmp_path):
    result = invoke("--device", "cpu", "serve", "transformer", tmp_path, "--model-parallel", 2,
                    "--continuous")
    assert result.exit_code == 2
    assert "--model-parallel is incompatible with --continuous" in result.output
