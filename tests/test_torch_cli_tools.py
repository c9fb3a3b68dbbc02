"""The port's CLI commands beside its main path, on the CPU: ``export-dataset``
and ``.tfrecord`` datasets in ``train`` and ``evaluate``, ``visualize-training``,
``summary``, ``synthesize`` and ``profile``. Held against the JAX CLI where both
write or print the same thing: identical ``.tfrecord`` files and WAVs from the
same ``--seed``, ``visualize-training``'s stdout character for character, the
JAX model's parameter counts. One tiny corpus, preprocessed once by the
port's CLI (module-scoped ``processed``), serves every case."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import composer_tpu.cli as jax_cli
from composer_tpu_torch import cli as port_cli
from composer_tpu_torch import config as config_module
from composer_tpu_torch.midi import Note, NoteSequence, SustainPeriod
from composer_tpu_torch.models import ModelType, create_model
from composer_tpu_torch.train.trainer import Trainer

SEED = 9
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
        decoder_layers_count: 2
        attention_head_count: 2
        use_relative_attention: true
        use_pallas_attention: true
        attention_dropout_rate: 0.0
        residual_dropout_rate: 0.0
        layer_normalization_epsilon: 0.00001
        scale_attention: true
        initializer_mean: 0
        initializer_stddev: 0.02
        use_layer_normalization: true
    train: {batch_size: 2, learning_rate: 0.01}
"""

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them fastest, and
    beside other test workers more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def invoke(cli, *args):
    return CliRunner().invoke(cli, [str(a) for a in args], catch_exceptions=False)


def run_both(*args):
    """The same command through both CLIs with ``--seed SEED``: (port, JAX)."""
    results = (invoke(port_cli.cli, "--seed", SEED, "--device", "cpu", *args),
               invoke(jax_cli.cli, "--seed", SEED, *args))
    for result in results:
        assert result.exit_code == 0, result.output
    return results


def port(*args):
    result = invoke(port_cli.cli, "--seed", SEED, "--device", "cpu", *args)
    assert result.exit_code == 0, result.output
    return result


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """Four MIDI files of random notes (numpy seed 6), preprocessed by the
    port's CLI with a train/test split and no augmentation."""
    root = tmp_path_factory.mktemp("cli_tools")
    config = root / "config.yml"
    config.write_text(TINY_CONFIG)
    raw = root / "raw"
    raw.mkdir()
    rng = np.random.default_rng(6)
    for index in range(4):
        t, notes = 0.0, []
        for _ in range(80):
            duration = float(rng.integers(80, 500))
            notes.append(Note(t, t + duration, int(rng.integers(40, 90)),
                              int(rng.integers(20, 120))))
            t += float(rng.integers(40, 250))
        NoteSequence(notes, [SustainPeriod(0, t / 4)]).to_midi(str(raw / f"p{index}.mid"))
    port("preprocess", "transformer", raw, root / "processed", "-c", config, "--no-transform",
         "--split", "--test-percent", 0.5, "-w", 1)
    return root, config, raw, root / "processed"


@pytest.fixture(scope="module")
def exported(processed):
    """The port's ``export-dataset`` of the whole corpus, and ``train -e 1``
    from that ``.tfrecord``."""
    root, config, _, data = processed
    record = root / "corpus.tfrecord"
    port("export-dataset", "transformer", data, record, "-c", config)
    port("train", "transformer", record, "-c", config, "--logdir", root / "logs", "-e", 1,
         "--save-freq-mode", "epoch", "--no-show-progress-bar")
    return record, next((root / "logs").glob("transformer-*"))


@pytest.mark.parametrize("model_type,options", [
    ("transformer", ()), ("transformer", ("--use-generator",)),
    ("music_rnn", ("--max-files", 3))], ids=["in_memory", "use_generator", "music_rnn"])
def test_export_dataset_writes_the_jax_clis_file(processed, model_type, options, tmp_path):
    _, config, _, data = processed
    # Each CLI on its own copy: --use-generator packs a cache beside the files.
    copies = {name: shutil.copytree(data, tmp_path / name) for name in ("port", "jax")}
    ours = invoke(port_cli.cli, "--seed", SEED, "export-dataset", model_type, copies["port"],
                  tmp_path / "ours.tfrecord", "-c", config, *options)
    theirs = invoke(jax_cli.cli, "--seed", SEED, "export-dataset", model_type, copies["jax"],
                    tmp_path / "theirs.tfrecord", "-c", config, *options)
    assert ours.exit_code == theirs.exit_code == 0, ours.output + theirs.output
    written = (tmp_path / "ours.tfrecord").read_bytes()
    assert len(written) > 1000 and written == (tmp_path / "theirs.tfrecord").read_bytes()


def test_train_and_evaluate_from_the_tfrecord(processed, exported, monkeypatch):
    """``train`` wrote a checkpoint with finite losses; ``evaluate`` on the
    ``.tfrecord`` equals ``Trainer.evaluate`` on the same batches read from
    the ``.data`` directory (the export's file order under ``--seed``,
    shuffling off)."""
    _, config_path, _, data = processed
    record, logdir = exported
    rows = [json.loads(line) for line in
            (logdir / "train" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in rows if r["name"] == "loss"]
    assert losses and np.all(np.isfinite(losses))

    scores = []
    real = Trainer.evaluate
    monkeypatch.setattr(Trainer, "evaluate",
                        lambda self, *a, **k: scores.append(real(self, *a, **k)) or scores[-1])
    port("evaluate", "transformer", record, logdir)
    assert len(scores) == 1

    config = config_module.get(config_path)
    monkeypatch.setattr(port_cli, "_GLOBAL_SEED", SEED)
    np.random.seed(SEED)  # the file order export-dataset drew
    batches = port_cli.get_dataset(ModelType.TRANSFORMER, data, config,
                                   shuffle_dataset=False, show_progress_bar=False)
    model, _ = create_model(ModelType.TRANSFORMER, config, device="cpu")
    trainer = Trainer(model, ModelType.TRANSFORMER, 1e-3, device="cpu")
    state = trainer.restore(logdir, 2, 16)
    expected = real(trainer, batches, state)
    assert np.isfinite(expected["loss"])
    for key in ("loss", "accuracy"):
        assert scores[0][key] == pytest.approx(expected[key], rel=1e-6, abs=0)


def test_a_mismatched_tfrecord_is_refused(exported, tmp_path):
    record = exported[0]
    other = tmp_path / "config.yml"
    other.write_text(TINY_CONFIG.replace("batch_size: 2", "batch_size: 3"))
    with pytest.raises(port_cli.DatasetError, match="batch size of 3 but found 2"):
        invoke(port_cli.cli, "--device", "cpu", "train", "transformer", record, "-c", other,
               "--logdir", tmp_path / "logs", "-e", 1)
    # A MusicRNN run on a Transformer export asks first; "n" aborts.
    result = CliRunner().invoke(port_cli.cli, ["--device", "cpu", "visualize-training",
                                               "music_rnn", str(record), "-c", str(other)],
                                input="n\n")
    assert result.exit_code == 1 and "Do you want to continue?" in result.output


@pytest.mark.parametrize("source", ["directory", "tfrecord"])
@pytest.mark.parametrize("decode", ["--decode-events", "--no-decode-events"])
def test_visualize_training_prints_the_jax_output(processed, exported, source, decode):
    _, config, _, data = processed
    path = data if source == "directory" else exported[0]
    ours, theirs = run_both("visualize-training", "transformer", path, "-c", config,
                            "--steps", 12, decode)
    assert "Step 12" in ours.stdout and ours.stdout == theirs.stdout


@pytest.mark.parametrize("model_type", ["transformer", "music_rnn"])
@pytest.mark.parametrize("which_config", ["default", "tiny"])
def test_summary_counts_equal_the_jax_models(processed, model_type, which_config):
    import jax
    import jax.numpy as jnp

    from composer_tpu import config as jax_config
    from composer_tpu.models import ModelType as JaxModelType
    from composer_tpu.models import create_model as jax_create_model

    config_path = jax_config.get_default_config_path() if which_config == "default" \
        else processed[1]
    model, vocab_size = jax_create_model(JaxModelType(model_type), jax_config.get(config_path))
    variables = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32)))
    expected = {name.replace("OptimizedLSTMCell_", "lstm_"): sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree))
        for name, tree in variables["params"].items()}

    printed = port("summary", model_type, "-c", config_path).stdout.splitlines()
    rows = printed[printed.index(next(line for line in printed if line.startswith("--"))) + 1:-2]
    top = {row.split()[0]: int(row.split()[-1].replace(",", "")) for row in rows
           if "." not in row.split()[0]}
    assert top == expected
    assert printed[-1] == f"Event vocabulary size: {vocab_size}"
    assert printed[-2].startswith(f"Total parameters: {sum(expected.values()):,} ")


def test_synthesize_builtin_writes_the_jax_clis_wav(processed, tmp_path):
    raw = processed[2]
    for name in ("ours", "theirs"):
        (tmp_path / name).mkdir()
        shutil.copy(raw / "p1.mid", tmp_path / name / "p1.mid")
    assert invoke(port_cli.cli, "synthesize", tmp_path / "ours" / "p1.mid", "--renderer",
                  "builtin").exit_code == 0
    assert invoke(jax_cli.cli, "synthesize", tmp_path / "theirs" / "p1.mid", "--renderer",
                  "builtin").exit_code == 0
    ours = (tmp_path / "ours" / "p1.wav").read_bytes()
    assert len(ours) > 10_000 and ours == (tmp_path / "theirs" / "p1.wav").read_bytes()


def test_synthesize_fluidsynth_without_fluidsynth_exits_cleanly(processed, tmp_path,
                                                                monkeypatch):
    monkeypatch.setattr(port_cli, "which", lambda name: None)
    shutil.copy(processed[2] / "p0.mid", tmp_path / "p0.mid")
    result = CliRunner().invoke(port_cli.cli, ["synthesize", str(tmp_path / "p0.mid"),
                                               "--renderer", "fluidsynth"])
    assert result.exit_code == 1 and isinstance(result.exception, SystemExit)
    assert "Traceback" not in result.output and not (tmp_path / "p0.wav").exists()


@pytest.mark.parametrize("model_type", ["transformer", "music_rnn"])
def test_profile_writes_a_trace_with_the_decode_span(processed, model_type, tmp_path):
    port("profile", model_type, tmp_path / "trace", "-c", processed[1], "--steps", 1,
         "--decode-length", 8)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = {str(event.get("name", "")) for event in events}
    assert {"decode", "train_step 1"} <= names and "train_step 2" not in names
