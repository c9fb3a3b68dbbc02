"""The port's CLI with ``music_rnn`` on the CPU: ``preprocess``, ``train``,
``evaluate``, ``generate`` and ``serve`` on a tiny config of its own (one
LSTM layer of 16, window 16, batch 2) and three MIDI files of random notes.

``generate``'s MIDI equals ``generate_ids`` on the restored weights (the
BatchNorm running statistics travel with them), and ``serve`` answers a
greedy request with the ids of a lone ``generate_ids``. ``serve`` runs in
this process: its server's ``serve_forever`` is replaced by one that posts
one request to the real server in a thread, then stops the command as
Ctrl-C does. Every wait is bounded.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import composer_tpu_torch.serving as serving
from composer_tpu_torch import cli as port_cli
from composer_tpu_torch.config import get as get_config
from composer_tpu_torch.midi import Note, NoteSequence
from composer_tpu_torch.midi.events import EventSequence
from composer_tpu_torch.midi.vocab import vocabulary_from_config
from composer_tpu_torch.models import ModelType, create_model
from composer_tpu_torch.train.checkpoint import CheckpointManager
from composer_tpu_torch.train.generate import generate_ids
from composer_tpu_torch.train.trainer import Trainer

WAIT = 60.0  # seconds: the bound on every blocking wait

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
        lstm_dropout_probability: 0.2
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


def port(*args):
    result = CliRunner().invoke(port_cli.cli, ["--seed", "4", "--device", "cpu"]
                                + [str(a) for a in args], catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``preprocess`` then ``train -e 1`` of music_rnn: (root, config path,
    processed corpus, the run's logdir)."""
    root = tmp_path_factory.mktemp("rnn_cli")
    config = root / "config.yml"
    config.write_text(TINY_CONFIG)
    raw = root / "raw"
    raw.mkdir()
    rng = np.random.default_rng(8)
    for index in range(3):
        t, notes = 0.0, []
        for _ in range(50):
            duration = float(rng.integers(80, 500))
            notes.append(Note(t, t + duration, int(rng.integers(40, 90)),
                              int(rng.integers(20, 120))))
            t += float(rng.integers(40, 250))
        NoteSequence(notes).to_midi(str(raw / f"p{index}.mid"))
    processed = root / "processed"
    port("preprocess", "music_rnn", raw, processed, "-c", config, "-w", 1, "--no-transform",
         "--test-percent", 0.34)
    port("train", "music_rnn", processed, "-c", config, "--logdir", root / "logs", "-e", 1,
         "--save-freq-mode", "epoch", "--no-show-progress-bar")
    return root, config, processed, next((root / "logs").glob("music_rnn-*"))


def _restored(logdir):
    config = get_config(logdir / "config.yml")
    model, _ = create_model(ModelType.MUSIC_RNN, config, device="cpu")
    Trainer(model, ModelType.MUSIC_RNN, 0.01, device="cpu").restore(logdir, 2, 16)
    return model, config


def test_train_checkpoints_the_batch_norm_statistics(trained):
    _, _, _, logdir = trained
    assert (logdir / "config.yml").exists()
    checkpoints = CheckpointManager(logdir)
    state = checkpoints.restore()
    assert state["step"] == checkpoints.latest_step() + 1 > 1 and state["epoch"] == 2
    params = state["params"]
    # Training moved the running statistics off their initial 0 and 1.
    assert params["batch_norm_0.running_mean"].abs().max() > 0
    assert not torch.equal(params["batch_norm_0.running_var"], torch.ones(16))
    assert state["opt_state"]["count"] == checkpoints.latest_step()


def test_evaluate_scores_the_restored_model(trained, monkeypatch):
    _, _, processed, logdir = trained
    scores = []
    real = Trainer.evaluate
    monkeypatch.setattr(Trainer, "evaluate",
                        lambda self, *a, **k: scores.append(real(self, *a, **k)) or scores[-1])
    port("evaluate", "music_rnn", processed, logdir)
    assert len(scores) == 1 and np.isfinite(scores[0]["loss"])
    assert 0.0 <= scores[0]["accuracy"] <= 1.0


def test_generate_writes_what_generate_ids_gives(trained):
    """Greedy from the seeded random prompt: the MIDI equals ``generate_ids``
    on the restored weights and running statistics, rendered the same way."""
    root, _, _, logdir = trained
    out = root / "greedy.mid"
    port("generate", "music_rnn", logdir, out, "-l", 24, "--temperature", 0)
    model, config = _restored(logdir)
    vocab = vocabulary_from_config(config)
    rng = np.random.default_rng(4)  # the CLI's --seed
    prompt = np.array([vocab.velocity_offset + vocab.velocity_bins // 2,
                       int(rng.integers(48, 72))], dtype=np.int32)
    ids = generate_ids(model, ModelType.MUSIC_RNN, None, prompt, length=24, temperature=0.0)
    expected = root / "expected.mid"
    EventSequence.from_ids(ids, config.dataset.time_step_increment,
                           config.dataset.max_time_steps, config.dataset.velocity_bins,
                           ).to_note_sequence().to_midi(str(expected))
    assert out.read_bytes() == expected.read_bytes()
    port("generate", "music_rnn", logdir, root / "sampled.mid", "-l", 24, "--top-k", 5)
    assert (root / "sampled.mid").stat().st_size > 0


def test_serve_answers_like_generate_ids(trained, monkeypatch):
    _, _, _, logdir = trained
    answers, build = [], serving.build_server

    def building(service, config, **kwargs):
        server = build(service, config, **kwargs)
        real_serve = server.serve_forever

        def serve_once():
            thread = threading.Thread(target=real_serve, daemon=True)
            thread.start()
            try:
                request = urllib.request.Request(
                    f"http://127.0.0.1:{server.server_port}/v1/generate",
                    data=json.dumps({"events": [3, 4, 5], "length": 6,
                                     "temperature": 0.0}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(request, timeout=WAIT) as response:
                    answers.append((service.model_type, json.loads(response.read())))
            finally:
                server.shutdown()
                thread.join(timeout=WAIT)
            raise KeyboardInterrupt  # the command's Ctrl-C path

        server.serve_forever = serve_once
        return server

    monkeypatch.setattr(serving, "build_server", building)
    port("serve", "music_rnn", logdir, "--port", 0)
    model, _ = _restored(logdir)
    expected = generate_ids(model, ModelType.MUSIC_RNN, None, np.array([3, 4, 5]), length=6,
                            temperature=0.0)
    assert answers == [(ModelType.MUSIC_RNN, {"events": expected.tolist()})]
