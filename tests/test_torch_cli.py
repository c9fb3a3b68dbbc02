"""The port's CLI, ``python -m composer_tpu_torch.cli``, on the CPU.

Held against the JAX CLI where both write the same thing: ``preprocess``
gives byte-identical ``.data`` trees and configs, and ``load_dataset`` the
same batches. Then the port's own workflow on ``--device cpu``, the pattern
of ``tests/test_cli.py``: ``make-config``, ``preprocess``, ``train``, resume,
``evaluate``, ``generate`` with and without a prompt, and ``serve`` as a
subprocess (every wait bounded), run-to-completion and continuous. Also
``remat`` (loss and gradients unchanged, dropout on) and ``profile_dir``.
The port trains once, in the module-scoped ``trained``.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import composer_tpu.cli as jax_cli
from composer_tpu.data import loader as jax_loader
from composer_tpu.midi import Note, NoteSequence, SustainPeriod
from composer_tpu_torch import cli as port_cli
from composer_tpu_torch.data import loader
from composer_tpu_torch.data.preprocess import get_processed_files
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig
from composer_tpu_torch.train.checkpoint import CheckpointManager
from composer_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 120  # the bound on every wait for the serve subprocess

# tests/test_cli.py's tiny config.
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
    train: {batch_size: 2, learning_rate: 0.01}
"""


def invoke(cli, *args):
    return CliRunner().invoke(cli, [str(a) for a in args], catch_exceptions=False)


def port(*args, device="cpu"):
    result = invoke(port_cli.cli, "--seed", 9, "--device", device, *args)
    assert result.exit_code == 0, result.output
    return result


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The tiny config and six MIDI files of random notes (numpy seed 5)."""
    root = tmp_path_factory.mktemp("port_cli")
    config = root / "config.yml"
    config.write_text(TINY_CONFIG)
    raw = root / "raw"
    raw.mkdir()
    rng = np.random.default_rng(5)
    for index in range(6):
        t, notes = 0.0, []
        for _ in range(60):
            duration = float(rng.integers(80, 500))
            notes.append(Note(t, t + duration, int(rng.integers(40, 90)),
                              int(rng.integers(20, 120))))
            t += float(rng.integers(40, 250))
        NoteSequence(notes, [SustainPeriod(0, t / 4)]).to_midi(str(raw / f"p{index}.mid"))
    return root, config, raw


@pytest.fixture(scope="module")
def preprocessed(workspace):
    """``preprocess`` with ``--seed 9``, ``--transform`` and ``--split`` in
    both CLIs (the port's with two worker processes)."""
    root, config, raw = workspace
    args = ("transformer", raw, None, "-c", config, "--transform", "--split")
    outputs = {}
    for name, cli, workers in (("jax", jax_cli.cli, 1), ("port", port_cli.cli, 2)):
        outputs[name] = root / f"processed_{name}"
        call = [a if a is not None else outputs[name] for a in args]
        result = invoke(cli, "--seed", 9, "preprocess", *call, "-w", workers)
        assert result.exit_code == 0, result.output
    return outputs


@pytest.fixture(scope="module")
def trained(workspace, preprocessed):
    """The port's ``train -e 1`` on its own preprocessed corpus."""
    root, config, _ = workspace
    port("train", "transformer", preprocessed["port"], "-c", config, "--logdir",
         root / "logs", "-e", 1, "--save-freq-mode", "epoch", "--no-show-progress-bar")
    return next((root / "logs").glob("transformer-*"))


def test_help_lists_the_commands():
    result = subprocess.run([sys.executable, "-m", "composer_tpu_torch.cli", "--help"],
                            cwd=REPO, capture_output=True, text=True, timeout=60)
    assert result.returncode == 0, result.stderr
    for command in ("make-config", "preprocess", "train", "evaluate", "generate", "serve",
                    "import-checkpoint", "export-dataset", "summary", "visualize-training",
                    "synthesize", "profile", "benchmark"):
        assert command in result.stdout


def test_make_config_copies_the_port_default(tmp_path):
    target = tmp_path / "my_config.yml"
    port("make-config", target)
    default = REPO / "composer_tpu_torch" / "default_config.yml"
    assert target.read_bytes() == default.read_bytes()


def test_preprocess_writes_the_jax_clis_files(preprocessed):
    """Names and bytes of every ``.data`` file, and ``config.yml``, equal the
    JAX CLI's; ``metadata.json`` too, apart from paths and times."""
    trees = {}
    for name, directory in preprocessed.items():
        trees[name] = {str(p.relative_to(directory)): p.read_bytes()
                       for p in sorted(directory.rglob("*")) if p.is_file()}
    metadata = {name: json.loads(tree.pop("metadata.json")) for name, tree in trees.items()}
    assert trees["port"].keys() == trees["jax"].keys()
    assert len([k for k in trees["jax"] if k.endswith(".data")]) == 4 * 10 + 2
    for key, data in trees["jax"].items():
        assert trees["port"][key] == data, key
    for entry in metadata.values():
        for key in ("local_time", "utc_time", "raw_dataset_path", "output_directory"):
            entry.pop(key)
    assert metadata["port"] == metadata["jax"]


@pytest.mark.parametrize("mode", ["in_memory", "streaming", "clamp_batch"])
def test_load_dataset_gives_the_original_batches(preprocessed, mode, tmp_path):
    files = get_processed_files(preprocessed["port"] / "train")
    kwargs = {"streaming": mode == "streaming", "clamp_batch": mode == "clamp_batch"}
    batch = 10_000 if mode == "clamp_batch" else 3
    datasets = []
    for name, module in (("jax", jax_loader), ("port", loader)):
        datasets.append(module.load_dataset(files, batch, 16, shuffle=True, seed=9,
                                            num_workers=2, cache_dir=tmp_path / name,
                                            **kwargs))
    ours, original = datasets[1], datasets[0]
    assert type(ours).__name__ == type(original).__name__
    assert (len(ours), ours.batch_size) == (len(original), original.batch_size)
    for _ in range(2):  # two epochs: the reshuffle follows the same stream
        pairs = list(zip(ours, original))
        assert len(pairs) == len(original) > 0
        for (x, y), (x0, y0) in pairs:
            np.testing.assert_array_equal(x, x0)
            np.testing.assert_array_equal(y, y0)


@pytest.mark.parametrize("use_pallas,window", [(False, 32), (True, 128)],
                         ids=["plain", "flash"])
def test_remat_keeps_loss_and_gradients_with_dropout(use_pallas, window):
    """``remat`` recomputes each block in the backward pass; the recompute
    must draw the forward's dropout bits, so loss, every gradient and the
    generator's final state equal those without it (dropout 0.1, on the
    plain attention and on flash attention's plain version)."""
    config = TransformerConfig(vocab_size=390, embed_dim=32, window_size=window, num_layers=2,
                               num_heads=2, use_relative_attention=True,
                               attention_dropout_rate=0.1, residual_dropout_rate=0.1,
                               use_pallas_attention=use_pallas)
    tokens = torch.randint(0, 390, (2, window), generator=torch.Generator().manual_seed(1))
    runs = []
    for remat in (False, True):
        model = Transformer(TransformerConfig(**{**config.__dict__, "remat": remat}))
        model.reset_parameters(torch.Generator().manual_seed(0))
        generator = torch.Generator().manual_seed(5)
        logits, _ = model(tokens, deterministic=False, generator=generator)
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 390), tokens.reshape(-1))
        loss.backward()
        runs.append((loss.item(), {n: p.grad for n, p in model.named_parameters()},
                     generator.get_state()))
    (loss, grads, state), (remat_loss, remat_grads, remat_state) = runs
    assert remat_loss == loss
    for name, grad in grads.items():
        torch.testing.assert_close(remat_grads[name], grad, rtol=0, atol=0, msg=name)
    assert torch.equal(remat_state, state)


def test_profile_dir_traces_steps_two_on(tmp_path):
    """``Trainer.train(profile_dir=...)`` writes a Chrome trace holding steps
    [2, 2 + profile_steps) and neither step 1 nor a later one."""
    from composer_tpu_torch.data import WindowDataset

    config = TransformerConfig(vocab_size=390, embed_dim=16, window_size=16, num_layers=1,
                               num_heads=2)
    trainer = Trainer(Transformer(config), ModelType.TRANSFORMER, 1e-3, device="cpu")
    state = trainer.init_state(2, 16)
    stream = np.random.default_rng(0).integers(0, 390, 6 * 2 * 17)
    trainer.train(WindowDataset(stream, 2, 16, shuffle=False), state, tmp_path / "log",
                  epochs=1, show_progress_bar=False, profile_dir=tmp_path / "profile",
                  profile_steps=3)
    events = json.loads((tmp_path / "profile" / "trace.json").read_text())["traceEvents"]
    steps = {e["name"] for e in events if str(e.get("name", "")).startswith("train_step ")}
    assert steps == {"train_step 2", "train_step 3", "train_step 4"}


def test_port_cli_workflow_on_the_cpu(workspace, preprocessed, trained, monkeypatch):
    """Resume, evaluate and generate (with a MIDI prompt and without),
    deterministic under ``--seed``."""
    root, _, raw = workspace
    processed = preprocessed["port"]
    first = CheckpointManager(trained).latest_step()
    assert (trained / "config.yml").exists() and first > 0
    resumed = root / "resumed"
    shutil.copytree(trained, resumed)
    port("train", "transformer", processed, "--restoredir", resumed, "-e", 2,
         "--save-freq-mode", "epoch", "--no-show-progress-bar")
    assert CheckpointManager(resumed).latest_step() == 2 * first

    scores = []
    real = Trainer.evaluate
    monkeypatch.setattr(Trainer, "evaluate",
                        lambda self, *a, **k: scores.append(real(self, *a, **k)) or scores[-1])
    port("evaluate", "transformer", processed, trained)
    assert len(scores) == 1 and np.isfinite(scores[0]["loss"]) \
        and 0.0 <= scores[0]["accuracy"] <= 1.0

    outputs = []
    for index in range(2):
        out = root / f"generated{index}.mid"
        port("generate", "transformer", trained, out, "-p", raw / "p0.mid",
             "--prompt-length", 4, "-l", 24)
        outputs.append(out.read_bytes())
    assert outputs[0] == outputs[1]
    port("generate", "transformer", trained, root / "random.mid", "-l", 16)
    assert (root / "random.mid").stat().st_size > 0


def test_device_cuda_fails_cleanly_without_a_card(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    result = invoke(port_cli.cli, "--seed", 9, "generate", "transformer", trained,
                    tmp_path / "out.mid", "-l", 4)
    assert result.exit_code == 2
    assert "--device cuda" in result.output and "--device cpu" in result.output
    assert not (tmp_path / "out.mid").exists()


def test_unported_choices_fail_with_their_roadmap_item(workspace, preprocessed, trained,
                                                       tmp_path):
    root, config, _ = workspace
    # A --model-parallel that does not divide the 2 heads is a usage error,
    # raised before any rank starts.
    result = invoke(port_cli.cli, "--device", "cpu", "train", "transformer",
                    preprocessed["port"], "-c", config, "--model-parallel", 3,
                    "--logdir", tmp_path)
    assert result.exit_code == 2 and "does not divide the 2 attention heads" in result.output
    assert not list(tmp_path.iterdir())  # no logdir left behind
    # .tfrecord datasets are read as the JAX CLI reads them: an empty file
    # raises the JAX reader's DatasetError.
    record = tmp_path / "train.tfrecord"
    record.write_bytes(b"")
    with pytest.raises(port_cli.DatasetError, match="Empty TFRecord file"):
        invoke(port_cli.cli, "--device", "cpu", "evaluate", "transformer", record, trained)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as response:
        return json.loads(response.read())


@pytest.mark.parametrize("continuous", [False, True], ids=["batched", "continuous"])
def test_serve_answers_like_generate(workspace, trained, continuous, tmp_path):
    """``serve --device cpu`` in a subprocess, as a user starts it: a greedy
    MIDI-prompted request returns the MIDI that ``generate --temperature 0``
    writes for the same prompt, and SIGINT shuts it down, logging the
    kernels' launches."""
    _, _, raw = workspace
    expected = tmp_path / "expected.mid"
    port("generate", "transformer", trained, expected, "-p", raw / "p1.mid",
         "--prompt-length", 4, "-l", 24, "--temperature", 0)
    free = _free_port()
    args = [sys.executable, "-m", "composer_tpu_torch.cli", "--seed", "9", "--device", "cpu",
            "serve", "transformer", str(trained), "--port", str(free)]
    if continuous:
        args += ["--continuous", "--max-batch-size", "2", "--seg-steps", "4",
                 "--serve-cache-len", "128"]
    log = tmp_path / "serve.log"
    with open(log, "wb") as sink:
        process = subprocess.Popen(args, cwd=REPO, stdout=sink, stderr=subprocess.STDOUT,
                                   env={**os.environ, "PYTHONUNBUFFERED": "1"})
    try:
        deadline = time.monotonic() + DEADLINE_S
        health = None
        while health is None:
            assert process.poll() is None, log.read_text()
            assert time.monotonic() < deadline, "serve did not come up: " + log.read_text()
            try:
                health = _get(f"http://127.0.0.1:{free}/v1/health", timeout=2)
            except OSError:
                time.sleep(0.2)
        assert health["backend"] == "cpu"
        body = {"midi_base64": base64.b64encode((raw / "p1.mid").read_bytes()).decode(),
                "prompt_length": 4, "length": 24, "temperature": 0.0}
        request = urllib.request.Request(f"http://127.0.0.1:{free}/v1/generate",
                                         data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=DEADLINE_S) as response:
            answer = json.loads(response.read())
        assert base64.b64decode(answer["midi_base64"]) == expected.read_bytes()
        process.send_signal(signal.SIGINT)
        assert process.wait(timeout=DEADLINE_S) == 0, log.read_text()
    finally:
        if process.poll() is None:
            process.kill()
            process.wait(timeout=30)
    assert "Kernel launches:" in log.read_text()
