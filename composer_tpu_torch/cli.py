"""The ``composer`` command-line interface of the PyTorch port.

    python -m composer_tpu_torch.cli [--seed N] [--device cuda|cpu] <command> ...

The port of ``composer_tpu/cli.py``, with its command names, arguments,
options, defaults and exit codes: ``make-config``, ``preprocess``,
``export-dataset``, ``summary``, ``visualize-training``, ``train``,
``evaluate``, ``generate``, ``synthesize``, ``serve``, ``profile`` and
``import-checkpoint``, for both model types (``transformer``,
``music_rnn``). The data commands (``make-config``, ``preprocess``,
``export-dataset``, ``visualize-training``, ``synthesize``) write or print
what the JAX package's do, byte for byte, and the commands that build a
model run on the device that ``--device`` names: the CUDA card by default,
the CPU when asked (``--device cpu``). Nothing falls back to the CPU:
``--device cuda`` where PyTorch sees no card stops with an error.

What differs from the JAX CLI:

* checkpoints are the port's (``<logdir>/checkpoints/<step>/state.pt``);
  ``scripts/convert_checkpoint.py`` converts one of either package into the
  other's, so that ``--restoredir`` works across the two;
* one device: ``--model-parallel`` above 1, and ``--data-parallel`` with more
  than one visible card, stop with an error (ROADMAP.md, Queue 1 item 8);
* ``--profile-dir`` and ``profile`` write a ``torch.profiler`` Chrome trace;
* ``summary`` prints a table of the PyTorch modules (Flax's ``tabulate`` has
  no counterpart) with the JAX model's parameter counts;
* the ``dropout_rng_impl`` config key (a TPU dropout-generator choice) is
  read and dropped: dropout draws from a ``torch.Generator`` seeded by
  ``--seed``;
* ``benchmark`` is not registered: it waits for the port's bench
  (ROADMAP.md, Queue 1 item 3).

Deliberate fixes over the reference, as in the JAX CLI: ``--seed`` seeds the
RNGs; ``--num-workers`` is honoured; ``generate`` decodes with a KV cache
over the full context; library errors become exit codes here.
"""

from __future__ import annotations

import datetime
import json
import logging
import subprocess
import time
from pathlib import Path
from shutil import copy2, which

import click
import numpy as np

import composer_tpu_torch.config as config_module
from composer_tpu_torch import ModelSaveFrequencyMode, logging_utils
from composer_tpu_torch.click_utils import EnumType
from composer_tpu_torch.exceptions import ComposerError, DatasetError, InvalidParameterError
from composer_tpu_torch.midi.events import NoteSequence, SustainPeriodEncodeMode
from composer_tpu_torch.midi.vocab import vocabulary_from_config
from composer_tpu_torch.models import (
    ModelType,
    create_model,
    get_batch_size,
    get_learning_rate,
    get_window_size,
)

_GLOBAL_SEED = 0
_DEVICE = "cuda"


def get_seed() -> int:
    return _GLOBAL_SEED


def get_device():
    """The ``torch.device`` of ``--device``. Without a CUDA device,
    ``--device cuda`` stops here with a usage error (exit code 2)."""
    import torch

    if _DEVICE == "cuda" and not torch.cuda.is_available():
        raise click.UsageError(
            "--device cuda: PyTorch sees no CUDA device on this machine. Pass "
            "--device cpu to run on the CPU."
        )
    return torch.device(_DEVICE)


@click.group()
@click.option("--verbosity", "-v", default="INFO", help="Either CRITICAL, ERROR, WARNING, INFO, or DEBUG.")
@click.option("--seed", type=int, default=None, help="Sets the seed of the random engine.")
@click.option("--device", type=click.Choice(["cuda", "cpu"]), default="cuda",
              help="The device that the commands which build a model (train, evaluate, "
                   "generate, serve, summary, profile, import-checkpoint) run on: "
                   "'cuda' (the card, the default) or 'cpu'.")
def cli(verbosity, seed, device):
    """A deep learning enabled music generator (PyTorch, on an NVIDIA card)."""
    global _GLOBAL_SEED, _DEVICE
    if seed is None:
        seed = int(time.time() * 1000.0) & 0x7FFFFFFF
    _GLOBAL_SEED = seed
    _DEVICE = device
    np.random.seed(seed & 0xFFFFFFFF)

    logging_utils.init()
    try:
        logging_utils.set_verbosity(verbosity)
    except ValueError as error:
        raise click.BadParameter(str(error))


def get_default_config():
    return config_module.get_default_config_path()


@cli.command()
@click.argument("filepath")
def make_config(filepath):
    """Write a fresh config file seeded from the packaged defaults."""
    copy2(get_default_config(), filepath)


# ----------------------------------------------------------------- datasets

def get_dataset(
    model_type,
    dataset_path,
    config,
    mode="",
    max_files=None,
    show_progress_bar=True,
    shuffle_files=True,
    shuffle_dataset=True,
    num_workers=8,
    use_generator=False,
):
    """Resolves a dataset path (directory of .data files or a .tfrecord file)
    into a batch iterable (parity: cli.py:185-276). ``use_generator`` selects
    the memory-bounded streaming path (reference models/__init__.py:147-158):
    ids are packed once into a disk cache and batches stream back per step.
    One process loads every window and every row of a record (the JAX CLI
    shards them over its hosts)."""
    from composer_tpu_torch.data import loader, preprocess, tfrecord

    if mode not in ("train", "test", ""):
        raise InvalidParameterError(
            f"'{mode}' is an invalid dataset mode! Must be 'train', 'test', or none."
        )

    dataset_path = Path(dataset_path)
    if dataset_path.is_dir():
        search_path = dataset_path / mode if mode else dataset_path
        if not search_path.exists():
            raise DatasetError(
                f"Could not get {mode} dataset: '{dataset_path}' has no {mode} folder."
            )
        files = preprocess.get_processed_files(search_path)
        if shuffle_files:
            np.random.shuffle(files)
        if max_files is not None:
            files = files[:max_files]
        return loader.load_dataset(
            files,
            get_batch_size(model_type, config),
            get_window_size(model_type, config),
            shuffle=shuffle_dataset,
            seed=get_seed(),
            num_workers=num_workers,
            show_progress_bar=show_progress_bar,
            # Evaluation sets may be smaller than one training batch.
            clamp_batch=(mode == "test"),
            streaming=use_generator,
        )

    if not dataset_path.is_file() or dataset_path.suffix != ".tfrecord":
        raise InvalidParameterError(
            f"'{dataset_path}' is an invalid dataset path! Expected a directory "
            "of processed files or a .tfrecord file."
        )

    # Streaming load: batches decode lazily from an mmap'd record index, so
    # resident memory stays O(one batch) however large the export is.
    header, record_dataset = tfrecord.TFRecordWindowDataset.from_file(
        dataset_path, shuffle=shuffle_dataset, seed=get_seed(),
        shard_count=1, shard_index=0,
    )
    dataset_model_type = ModelType(header["model_type"])
    if dataset_model_type != model_type:
        logging.warning(
            "Model type mismatch when loading '%s'. Expected %s but found %s. "
            "The TFRecord was probably exported with a different config.",
            dataset_path, model_type, dataset_model_type,
        )
        click.confirm(
            "Do you want to continue? This may cause errors or corrupt the training session.",
            abort=True,
        )
    if header["batch_size"] != get_batch_size(model_type, config):
        raise DatasetError(
            f"Expected a batch size of {get_batch_size(model_type, config)} "
            f"but found {header['batch_size']}."
        )
    if header["window_size"] != get_window_size(model_type, config):
        raise DatasetError(
            f"Expected a window size of {get_window_size(model_type, config)} "
            f"but found {header['window_size']}."
        )
    return record_dataset


@cli.command()
@click.argument("model-type", type=EnumType(ModelType, False))
@click.argument("dataset-path")
@click.argument("output-directory")
@click.option("--num-workers", "-w", default=16, help="The number of worker processes to spawn. Defaults to 16.")
@click.option("-c", "--config", "config_filepath", default=None,
              help="The path to the model configuration file. If unspecified, uses the default config.")
@click.option("--sustain-period-encode-mode", "-spe", default="extend",
              type=EnumType(SustainPeriodEncodeMode, False),
              help="The way in which sustain periods should be encoded. Defaults to EXTEND.")
@click.option("--transform/--no-transform", default=True,
              help="Whether to augment the dataset with pitch-shifted and time-stretched copies. Defaults to True.")
@click.option("--transform-percent", default=1.0,
              help="The percentage of the dataset to transform. Defaults to 100%% of the dataset.")
@click.option("--split/--no-split", default=True,
              help="Whether to split into train and test sets. Defaults to True.")
@click.option("--test-percent", default=0.30,
              help="The percentage of the dataset allocated to testing. Defaults to 30%%.")
@click.option("--metadata/--no-metadata", "output_metadata", default=True,
              help="Whether to output metadata. Defaults to True.")
def preprocess(model_type, dataset_path, output_directory, num_workers, config_filepath,
               sustain_period_encode_mode, transform, transform_percent, split,
               test_percent, output_metadata):
    """Convert a directory of raw MIDI files into model-ready .data files."""
    from composer_tpu_torch.data import preprocess as preprocess_module

    config = config_module.get(config_filepath or get_default_config())
    output_directory = Path(output_directory)

    if split:
        preprocess_module.split_dataset(
            config, dataset_path, output_directory, sustain_period_encode_mode,
            test_percent, transform, transform_percent, num_workers, seed=get_seed(),
        )
    else:
        preprocess_module.convert_all(
            config, dataset_path, output_directory, sustain_period_encode_mode,
            transform, transform_percent, num_workers, seed=get_seed(),
        )

    if output_metadata:
        with open(output_directory / "metadata.json", "w+") as metadata_file:
            json.dump(
                {
                    "local_time": str(datetime.datetime.now()),
                    "utc_time": str(datetime.datetime.now(datetime.timezone.utc)),
                    "model_type": str(model_type),
                    "raw_dataset_path": str(Path(dataset_path).absolute()),
                    "output_directory": str(output_directory.absolute()),
                    "sustain_period_encode_mode": str(sustain_period_encode_mode),
                    "transform": transform,
                    "transform_percent": transform_percent,
                    "split": split,
                    "test_percent": test_percent,
                    "seed": get_seed(),
                },
                metadata_file,
                indent=True,
            )
        copy2(config.filepath or get_default_config(), output_directory / "config.yml")


@cli.command()
@click.argument("model-type", type=EnumType(ModelType, False))
@click.argument("preprocessed-path")
@click.argument("output-path")
@click.option("-c", "--config", "config_filepath", default=None,
              help="The path to the model configuration file. If unspecified, uses the default config.")
@click.option("--use-generator/--no-use-generator", "use_generator", default=False,
              help="Stream batches from a disk-backed packed cache "
                   "(memory-bounded; same batches as the in-memory path).")
@click.option("--max-files", default=None, type=int,
              help="The maximum number of files to load. Defaults to all files.")
def export_dataset(model_type, preprocessed_path, output_path, config_filepath,
                   use_generator, max_files):
    """Pack a preprocessed dataset into a single TFRecord for fast startup."""
    from composer_tpu_torch.data import tfrecord

    config = config_module.get(config_filepath or get_default_config())
    dataset = get_dataset(
        model_type, preprocessed_path, config,
        shuffle_dataset=False, max_files=max_files, use_generator=use_generator,
    )
    logging.info("Writing dataset to TFRecord. This may take a while...")
    tfrecord.export_dataset(dataset, model_type.value, output_path)
    logging.info("Finished exporting '%s' as a TFRecord: '%s'", preprocessed_path, output_path)


def summary_rows(model, depth: int = 2) -> list:
    """``(path, type, parameters, count)`` for each module of ``model`` down
    to ``depth`` levels, and for each parameter held directly by a module
    above that depth (the Transformer's ``wte`` and ``wpe``); ``parameters``
    names the module's own tensors with their shapes, ``count`` is every
    parameter under it."""
    rows = []

    def visit(module, prefix: str, level: int) -> None:
        for name, tensor in module.named_parameters(recurse=False):
            if module is model:  # a top-level tensor is a row of its own
                rows.append((name, "Parameter", str(tuple(tensor.shape)), tensor.numel()))
        if level == depth:
            return
        for name, child in module.named_children():
            own = ", ".join(f"{key} {tuple(tensor.shape)}"
                            for key, tensor in child.named_parameters(recurse=False))
            rows.append((prefix + name, type(child).__name__, own,
                         sum(tensor.numel() for tensor in child.parameters())))
            visit(child, f"{prefix}{name}.", level + 1)

    visit(model, "", 0)
    return rows


@cli.command()
@click.argument("model-type", type=EnumType(ModelType, False))
@click.option("-c", "--config", "config_filepath", default=None,
              help="The path to the model configuration file. If unspecified, uses the default config.")
def summary(model_type, config_filepath):
    """Show the model's layer/parameter breakdown for a given config."""
    config = config_module.get(config_filepath or get_default_config())
    model, vocab_size = create_model(model_type, config, device=get_device())
    rows = [("module", "type", "parameters", "count")] + [
        (path, kind, own, f"{count:,}") for path, kind, own, count in summary_rows(model)]
    widths = [max(len(row[column]) for row in rows) for column in range(4)]
    title = (f"{type(model).__name__} summary (batch {get_batch_size(model_type, config)}, "
             f"window {get_window_size(model_type, config)}, depth 2)")
    print(title)
    for index, row in enumerate(rows):
        print("  ".join(cell.ljust(width) if column < 3 else cell.rjust(width)
                        for column, (cell, width) in enumerate(zip(row, widths))).rstrip())
        if index == 0:
            print("  ".join("-" * width for width in widths))
    total = sum(tensor.numel() for tensor in model.parameters())
    size = sum(tensor.numel() * tensor.element_size() for tensor in model.parameters())
    buffers = sum(tensor.numel() for tensor in model.buffers())
    print(f"Total parameters: {total:,} ({size / 1e6:.1f} MB)"
          + (f"; buffers (batch statistics): {buffers:,}" if buffers else ""))
    print(f"Event vocabulary size: {vocab_size}")


@cli.command()
@click.argument("model-type", type=EnumType(ModelType, False))
@click.argument("dataset-path")
@click.option("-c", "--config", "config_filepath", default=None,
              help="The path to the model configuration file. If unspecified, uses the default config.")
@click.option("--steps", default=5, help="The number of steps to visualize. Defaults to 5.")
@click.option("--decode-events/--no-decode-events", default=True,
              help="Whether events are decoded or displayed as raw integer ids.")
def visualize_training(model_type, dataset_path, config_filepath, steps, decode_events):
    """Displays the (input, expected output) training pairs from a dataset."""
    config = config_module.get(config_filepath or get_default_config())
    dataset = get_dataset(
        model_type, dataset_path, config, mode="train",
        max_files=5, show_progress_bar=False,
    )
    vocab = vocabulary_from_config(config)

    pairs = []
    for batch_x, batch_y in dataset:
        features = np.asarray(batch_x).reshape(-1)
        labels = np.asarray(batch_y).reshape(-1)
        for x, y in zip(features, labels):
            if len(pairs) == steps:
                break
            if decode_events:
                pairs.append((vocab.id_to_event(int(x)), vocab.id_to_event(int(y))))
            else:
                pairs.append((int(x), int(y)))
        if len(pairs) == steps:
            break

    input_line = ", ".join(str(x) for x, _ in pairs)
    output_line = ", ".join(str(y) for _, y in pairs)
    width = max(len("Input sequence: ") + len(input_line),
                len("Output sequence: ") + len(output_line))
    print("‾" * width)
    print(f"Input sequence: {input_line}")
    print("_" * width)
    print("‾" * width)
    print(f"Output sequence: {output_line}")
    print("_" * width)
    for index, (x, y) in enumerate(pairs):
        print(f"Step {index + 1}")
        print(f" - input:             {x}")
        print(f" - expected output:   {y}")


def get_config_from_restoredir(restoredir):
    config_filepath = Path(restoredir) / "config.yml"
    if not config_filepath.exists():
        logging.error(
            "Failed to restore model from '%s'! Could not find 'config.yml'.", restoredir
        )
        raise click.exceptions.Exit(1)
    return config_module.get(config_filepath)


_CONFIG_SNAPSHOT_BANNER = """\
#########################################################
# Datetime: {datetime}.
#########################################################
# This is an autogenerated backup of the configuration file
# used when invoking the train command.
#
# DO NOT MODIFY THIS FILE!
# Doing so may cause errors upon resuming training.
#########################################################
{config_source}
"""


def _make_trainer(model_type, config):
    from composer_tpu_torch.train.trainer import Trainer

    device = get_device()
    model, _ = create_model(model_type, config, device=device)
    train_section = (
        config.music_rnn if model_type == ModelType.MUSIC_RNN else config.transformer
    ).train
    # The JAX package's choice of TPU dropout generator has no counterpart:
    # dropout draws from a torch.Generator seeded by --seed.
    if train_section.get("dropout_rng_impl", None) not in (None, "auto", "default"):
        logging.info("Ignoring dropout_rng_impl=%s, a TPU setting.",
                     train_section["dropout_rng_impl"])
    return Trainer(
        model, model_type, get_learning_rate(model_type, config),
        seed=get_seed(),
        # Optional additive knobs (0 = the reference's bare Adam).
        warmup_steps=int(train_section.get("warmup_steps", 0)),
        gradient_clip_norm=float(train_section.get("gradient_clip_norm", 0.0)),
        device=device,
    )


def _refuse_parallelism(model_parallel: int, data_parallel: bool) -> None:
    """One device: tensor parallelism, and data parallelism over several
    cards, are not ported (ROADMAP.md, Queue 1 item 8)."""
    import torch

    if model_parallel > 1:
        raise click.BadParameter(
            f"--model-parallel {model_parallel}: tensor parallelism is not ported yet "
            "(ROADMAP.md, Queue 1 item 8).", param_hint="--model-parallel")
    if data_parallel and _DEVICE == "cuda" and torch.cuda.device_count() > 1:
        raise click.UsageError(
            f"{torch.cuda.device_count()} CUDA devices are visible, and data parallelism "
            "over several devices is not ported yet (ROADMAP.md, Queue 1 item 8). Pass "
            "--no-data-parallel to train on one device."
        )


@cli.command()
@click.argument("model-type", type=EnumType(ModelType, False))
@click.argument("dataset-path")
@click.option("--logdir", default="./output/logdir/", help="The root log directory. Defaults to './output/logdir'.")
@click.option("--restoredir", default=None, type=str, help="The directory of the model to continue training.")
@click.option("-c", "--config", "config_filepath", default=None,
              help="The path to the model configuration file. Ignored when --restoredir is given.")
@click.option("-e", "--epochs", default=10, help="The number of epochs to train for. Defaults to 10.")
@click.option("--use-generator/--no-use-generator", "use_generator", default=False,
              help="Stream batches from a disk-backed packed cache "
                   "(memory-bounded; same batches as the in-memory path).")
@click.option("--max-files", default=None, type=int,
              help="The maximum number of files to load. Defaults to all files.")
@click.option("--save-freq-mode", "save_frequency_mode", type=EnumType(ModelSaveFrequencyMode, False),
              default="global_step", help="The units of the save frequency. Defaults to GLOBAL_STEP.")
@click.option("--save-freq", "save_frequency", type=int, default=500,
              help="How often to save the model. Defaults to every 500 global steps.")
@click.option("--max-checkpoints", type=int, default=3,
              help="The maximum number of checkpoints to keep. Defaults to 3.")
@click.option("--show-progress-bar/--no-show-progress-bar", default=True,
              help="Whether to show an epoch progress bar. Defaults to True.")
@click.option("--data-parallel/--no-data-parallel", default=True,
              help="Shard batches over all visible devices (data parallelism). "
                   "The port trains on one device: with more than one visible "
                   "card, pass --no-data-parallel.")
@click.option("--model-parallel", type=int, default=1,
              help="Tensor-parallel degree. The port trains on one device: "
                   "only 1 (the default) is accepted.")
@click.option("--profile-dir", default=None, type=str,
              help="Capture a torch.profiler trace (a Chrome trace, trace.json) "
                   "of a few steps into this directory.")
def train(model_type, dataset_path, logdir, restoredir, config_filepath, epochs,
          use_generator, max_files, save_frequency_mode, save_frequency,
          max_checkpoints, show_progress_bar, data_parallel, model_parallel,
          profile_dir):
    """Run the training loop for the chosen model on a preprocessed dataset."""
    _refuse_parallelism(model_parallel, data_parallel)
    get_device()  # fail before a log directory is made

    if restoredir is not None:
        config = get_config_from_restoredir(restoredir)
        model_logdir = Path(restoredir)
    else:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        model_logdir = Path(logdir) / f"{model_type.name.lower()}-{stamp}"
        model_logdir.mkdir(parents=True, exist_ok=True)
        config = config_module.get(config_filepath or get_default_config())
        source = Path(config.filepath or get_default_config()).read_text()
        (model_logdir / "config.yml").write_text(
            _CONFIG_SNAPSHOT_BANNER.format(
                datetime=str(datetime.datetime.now()), config_source=source
            )
        )

    trainer = _make_trainer(model_type, config)
    batch = get_batch_size(model_type, config)
    window = get_window_size(model_type, config)

    if restoredir is not None:
        state = trainer.restore(model_logdir, batch, window)
    else:
        state = trainer.init_state(batch, window)

    dataset = get_dataset(
        model_type, dataset_path, config, "train",
        max_files=max_files, use_generator=use_generator,
    )
    trainer.train(
        dataset, state, model_logdir, epochs=epochs,
        save_frequency_mode=save_frequency_mode, save_frequency=save_frequency,
        max_checkpoints=max_checkpoints, show_progress_bar=show_progress_bar,
        profile_dir=profile_dir,
    )


@cli.command("import-checkpoint")
@click.argument("model-type", type=EnumType(ModelType, False))
@click.argument("checkpoint-dir")
@click.argument("output-logdir")
@click.option("--config", "-c", "config_filepath", default=None,
              help="The path of the configuration file the reference model was "
                   "trained with. Defaults to the default configuration.")
def import_checkpoint(model_type, checkpoint_dir, output_logdir, config_filepath):
    """Import a checkpoint trained by the TF reference implementation.

    Reads a tf.train.Checkpoint saved by the reference's train loop (weights,
    batch-norm statistics, step/epoch; requires TensorFlow for the read),
    converts it to the port's checkpoint format under OUTPUT_LOGDIR, and
    snapshots the config there, after which `generate`, `evaluate`, `serve`
    and `train --restoredir` accept OUTPUT_LOGDIR directly. Optimizer state
    does not transfer (resumed training restarts Adam).
    """
    from composer_tpu_torch.train.import_reference import import_reference_checkpoint

    get_device()  # fail before a log directory is made
    config = config_module.get(config_filepath or get_default_config())
    output_logdir = Path(output_logdir)
    output_logdir.mkdir(parents=True, exist_ok=True)
    state = import_reference_checkpoint(model_type, checkpoint_dir, output_logdir, config)
    # Snapshot the config only after a successful import: a failed import
    # must not leave a logdir that a later restore mistakes for a model's.
    source = Path(config.filepath or get_default_config()).read_text()
    (output_logdir / "config.yml").write_text(
        _CONFIG_SNAPSHOT_BANNER.format(
            datetime=str(datetime.datetime.now()), config_source=source
        )
    )
    logging.info(
        "Imported reference checkpoint into '%s' (step=%d, epoch=%d).",
        output_logdir, state.step, state.epoch,
    )


@cli.command()
@click.argument("model-type", type=EnumType(ModelType, False))
@click.argument("dataset-path")
@click.argument("restoredir")
@click.option("--use-generator/--no-use-generator", "use_generator", default=False,
              help="Stream batches from a disk-backed packed cache "
                   "(memory-bounded; same batches as the in-memory path).")
@click.option("--max-files", default=None, type=int,
              help="The maximum number of files to load. Defaults to all files.")
def evaluate(model_type, dataset_path, restoredir, use_generator, max_files):
    """Score a restored checkpoint on a dataset (mean NLL loss and accuracy)."""
    config = get_config_from_restoredir(restoredir)
    trainer = _make_trainer(model_type, config)
    state = trainer.restore(
        restoredir, get_batch_size(model_type, config), get_window_size(model_type, config)
    )
    dataset = get_dataset(
        model_type, dataset_path, config, "test",
        max_files=max_files, shuffle_dataset=False, use_generator=use_generator,
    )
    metrics = trainer.evaluate(dataset, state)
    logging.info(
        "- Finished evaluating model. Loss: %.4f, Accuracy: %.4f, Perplexity: %.2f",
        metrics["loss"], metrics["accuracy"], metrics["perplexity"],
    )


@cli.command()
@click.argument("model-type", type=EnumType(ModelType, False))
@click.argument("restoredir")
@click.argument("output-filepath")
@click.option("--prompt", "-p", default=None,
              help="The path of the MIDI file to prompt the network with. "
                   "Defaults to None, meaning a random prompt will be created.")
@click.option("--prompt-length", default=10, help="Number of events to take from the start of the prompt. Defaults to 10.")
@click.option("--length", "-l", "generate_length", default=1024,
              help="The length of the generated event sequence. Defaults to 1024.")
@click.option("--temperature", default=1.0,
              help="Dictates how random the result is. Lower is more predictable. Defaults to 1.0.")
@click.option("--top-k", default=0,
              help="Sample only from the k most likely events (0 disables; addition over the reference).")
@click.option("--top-p", default=0.0,
              help="Nucleus sampling: smallest probability mass p to sample from (0 disables; addition over the reference).")
@click.option("--engine", default="auto",
              type=click.Choice(["auto", "megakernel", "wide", "xla", "spec"]),
              help="Decode engine. 'auto' picks the hand-written kernels on the "
                   "card: speculative block decoding (spec_decode) for greedy "
                   "single-sequence runs, which gives the sequential kernel's "
                   "ids; the sequential kernel (decode_generate) otherwise; "
                   "decode_wide for models whose weights outgrow the card's L2. "
                   "'spec' forces speculation for sampled runs too (wins on "
                   "repetitive streams); 'xla' is the unfused path. On "
                   "--device cpu each engine runs its plain PyTorch version.")
def generate(model_type, restoredir, output_filepath, prompt, prompt_length,
             generate_length, temperature, top_k, top_p, engine):
    """Generate a MIDI file (one launch of a fused decode kernel on the card
    for a transformer; the LSTM stepped one event at a time for music_rnn)."""
    from composer_tpu_torch.midi.events import EventSequence
    from composer_tpu_torch.train.generate import generate_ids

    config = get_config_from_restoredir(restoredir)
    trainer = _make_trainer(model_type, config)
    trainer.restore(
        restoredir, get_batch_size(model_type, config), get_window_size(model_type, config)
    )
    vocab = vocabulary_from_config(config)

    if prompt is not None:
        prompt_sequence = NoteSequence.from_midi(prompt).trim_start()
        event_sequence = prompt_sequence.to_event_sequence(
            config.dataset.time_step_increment,
            config.dataset.max_time_steps,
            config.dataset.velocity_bins,
        )
        event_sequence.events = event_sequence.events[:prompt_length]
        prompt_ids = event_sequence.to_ids().astype(np.int32)
        if prompt_ids.size == 0:
            raise InvalidParameterError(
                f"Prompt MIDI '{prompt}' contains no events after encoding; "
                "use a file with at least one note (or omit --prompt for a "
                "random seed prompt)."
            )
    else:
        # New capability (the reference raised NotImplementedError,
        # cli.py:642-643): seed with a random NOTE_ON at moderate velocity,
        # drawn as the JAX CLI draws it, so both CLIs seed the same prompt.
        rng = np.random.default_rng(get_seed())
        prompt_ids = np.array(
            [vocab.velocity_offset + vocab.velocity_bins // 2,
             int(rng.integers(48, 72))],
            dtype=np.int32,
        )

    # None: the restored module's own weights and, for MusicRNN, its
    # BatchNorm running statistics (buffers of the module).
    ids = generate_ids(
        trainer.model, model_type, None, prompt_ids,
        length=generate_length, temperature=temperature, seed=get_seed(),
        top_k=top_k, top_p=top_p, engine=engine,
    )

    event_sequence = EventSequence.from_ids(
        ids,
        config.dataset.time_step_increment,
        config.dataset.max_time_steps,
        config.dataset.velocity_bins,
    )
    output_filepath = Path(output_filepath)
    output_filepath.parent.mkdir(parents=True, exist_ok=True)
    event_sequence.to_note_sequence().to_midi(str(output_filepath))
    logging.info("Wrote %d events to '%s'.", len(ids), output_filepath)


@cli.command()
@click.argument("model-type", type=EnumType(ModelType, False))
@click.argument("restoredir")
@click.option("--host", default="127.0.0.1", help="Bind address. Defaults to 127.0.0.1.")
@click.option("--port", default=8000, help="Bind port. Defaults to 8000.")
@click.option("--max-batch-size", default=8,
              help="Most concurrent requests coalesced into one batched decode. Defaults to 8.")
@click.option("--max-wait-ms", default=20.0,
              help="How long the batcher waits to fill a batch. Defaults to 20 ms.")
@click.option("--default-length", default=1024,
              help="Generation length when a request omits 'length'. Defaults to 1024.")
@click.option("--continuous/--no-continuous", default=False,
              help="Continuous batching (transformers): requests join a "
                   "running batch at segment boundaries instead of waiting "
                   "for the current batch to finish.")
@click.option("--seg-steps", default=64,
              help="Continuous mode: decode steps per scheduling segment "
                   "(admission/eviction granularity). Defaults to 64.")
@click.option("--serve-cache-len", default=2048,
              help="Continuous mode: per-slot KV capacity; bounds "
                   "prompt + length per request. Defaults to 2048.")
@click.option("--max-queue-depth", default=0,
              help="Most requests allowed to wait in the serving queue; "
                   "submits beyond it get HTTP 429. 0 (default) = unbounded.")
@click.option("--default-deadline-ms", default=0.0,
              help="Deadline applied to requests that send no 'deadline_ms'; "
                   "expiry returns HTTP 503. 0 (default) = none.")
@click.option("--prefix-cache-mb", default=32.0,
              help="Continuous mode: device-memory budget for the cross-request "
                   "prompt-prefix KV cache (repeated prompts admit with one "
                   "copy instead of a prefix forward). 0 disables. "
                   "Defaults to 32 MiB.")
@click.option("--continuous-engine", default="auto",
              type=click.Choice(["auto", "resident", "wide"]),
              help="Continuous mode kernel: 'resident' (decode_segment) keeps "
                   "each sequence's step on a thread-block cluster; 'wide' "
                   "(decode_segment_wide) streams the weights through every "
                   "SM (models whose weights outgrow the card's L2, e.g. "
                   "embed 1024). 'auto' (default) picks by model size.")
@click.option("--model-parallel", type=int, default=1,
              help="Tensor-parallel degree. The port serves from one device: "
                   "only 1 (the default) is accepted.")
def serve(model_type, restoredir, host, port, max_batch_size, max_wait_ms,
          default_length, continuous, seg_steps, serve_cache_len,
          max_queue_depth, default_deadline_ms, prefix_cache_mb,
          continuous_engine, model_parallel):
    """Serve generation over HTTP (POST /v1/generate, GET /v1/health).

    Restores the model once, keeps it resident on the device, and coalesces
    concurrent requests into batched decodes: one launch of the fused
    kernel per batch. Request body: {"events": [...]} or {"midi_base64":
    "..."} plus optional length/temperature/top_k/top_p/prompt_length/
    return_midi. With --continuous, a slot scheduler over the segmented
    decode kernel admits/evicts requests at segment boundaries. On shutdown (Ctrl-C) it logs each kernel's launches.
    """
    from composer_tpu_torch.ops import launch_counts
    from composer_tpu_torch.serving import (
        ContinuousGenerationService,
        GenerationService,
        build_server,
    )

    _refuse_parallelism(model_parallel, data_parallel=False)
    config = get_config_from_restoredir(restoredir)
    trainer = _make_trainer(model_type, config)
    trainer.restore(
        restoredir, get_batch_size(model_type, config), get_window_size(model_type, config)
    )
    vocab = vocabulary_from_config(config)
    # The services copy the restored module's state_dict: its weights and,
    # for MusicRNN, its BatchNorm running statistics.
    if continuous:
        service = ContinuousGenerationService(
            trainer.model, model_type, None, vocab.size,
            slots=max_batch_size, seg_steps=seg_steps,
            cache_len=serve_cache_len, seed=get_seed(),
            max_queue_depth=max_queue_depth,
            default_deadline_ms=default_deadline_ms,
            prefix_cache_mb=prefix_cache_mb,
            engine=continuous_engine, device=trainer.device,
        )
    else:
        service = GenerationService(
            trainer.model, model_type, None, vocab.size,
            max_batch_size=max_batch_size, max_wait_ms=max_wait_ms,
            seed=get_seed(), max_queue_depth=max_queue_depth,
            default_deadline_ms=default_deadline_ms, device=trainer.device,
        )
    server = build_server(
        service, config, host=host, port=port, default_length=default_length,
    )
    logging.info(
        "Serving %s on http://%s:%d (POST /v1/generate, GET /v1/health).",
        model_type.value, host, server.server_port,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logging.info("Shutting down.")
    finally:
        server.server_close()
        service.close()
        logging.info("Kernel launches: %s", json.dumps(launch_counts()))


@cli.command()
@click.argument("midi_filepath")
@click.option("--sf-path", "soundfont_filepath", default=None,
              help="The filepath of the soundfont to use. If not specified, uses the default soundfont.")
@click.option("--sf-save-path", "soundfont_save_path", default="data/soundfonts",
              help="The path to save the default soundfont to.")
@click.option("--chunk-size", default=32768, help="Bytes per download chunk. Defaults to 32768.")
@click.option("--renderer", default="auto",
              type=click.Choice(["auto", "fluidsynth", "builtin"]),
              help="'fluidsynth' uses a soundfont (the reference's path); "
                   "'builtin' is the dependency-free additive renderer "
                   "(composer_tpu_torch/midi/synth.py); 'auto' (default) prefers "
                   "fluidsynth and falls back to builtin when it is "
                   "missing.")
def synthesize(midi_filepath, soundfont_filepath, soundfont_save_path,
               chunk_size, renderer):
    """Synthesize a MIDI file to WAV (fluidsynth or the built-in renderer)."""
    midi_filepath = Path(midi_filepath)
    output_filepath = midi_filepath.parent / (midi_filepath.stem + ".wav")

    have_fluidsynth = which("fluidsynth") is not None
    if renderer == "fluidsynth" and not have_fluidsynth:
        logging.error(
            "Could not find FluidSynth, which is required for synthesization "
            "using a soundfont (use --renderer builtin for the offline "
            "fallback)."
        )
        raise click.exceptions.Exit(1)

    if renderer == "builtin" or (renderer == "auto" and not have_fluidsynth):
        from composer_tpu_torch.midi.synth import render_midi_to_wav

        if renderer == "auto":
            logging.info(
                "FluidSynth not found; rendering with the built-in additive "
                "synthesizer instead."
            )
        render_midi_to_wav(midi_filepath, output_filepath)
        logging.info("Wrote '%s' (built-in renderer).", output_filepath)
        return

    if soundfont_filepath is None:
        soundfont_filepath = _ensure_default_soundfont(Path(soundfont_save_path), chunk_size)

    subprocess.call([
        "fluidsynth", "-T", "wav",
        "-F", str(output_filepath),
        "-ni", str(soundfont_filepath), str(midi_filepath),
    ])


def _ensure_default_soundfont(save_path: Path, chunk_size: int) -> Path:
    """Downloads the default soundfont if missing (cli.py:698-731)."""
    DEFAULT_SOUNDFONT_GDRIVE_ID = "1md7ysI8JeLb6idc5ZX05_iOUTvgm_l-0"
    GDRIVE_DOWNLOAD_URL = "https://drive.google.com/uc?export=download"

    save_path.mkdir(parents=True, exist_ok=True)
    soundfont = save_path / "default.sf2"
    if soundfont.exists():
        return soundfont

    try:
        import requests
    except ImportError:
        logging.error("The 'requests' package is required to download the default soundfont.")
        raise click.exceptions.Exit(1)

    logging.info("Downloading default soundfont...")
    session = requests.Session()
    response = session.get(
        GDRIVE_DOWNLOAD_URL, params={"id": DEFAULT_SOUNDFONT_GDRIVE_ID}, stream=True
    )
    token = next(
        (v for k, v in response.cookies.items() if k.startswith("download_warning")), None
    )
    if token:
        response = session.get(
            GDRIVE_DOWNLOAD_URL,
            params={"id": DEFAULT_SOUNDFONT_GDRIVE_ID, "confirm": token},
            stream=True,
        )
    with open(soundfont, "wb+") as handle:
        for chunk in response.iter_content(chunk_size=chunk_size):
            if chunk:
                handle.write(chunk)
    return soundfont


@cli.command()
@click.argument("model-type", type=EnumType(ModelType, False))
@click.argument("output-dir")
@click.option("-c", "--config", "config_filepath", default=None,
              help="The path to the model configuration file.")
@click.option("--steps", default=5, help="Training steps to trace. Defaults to 5.")
@click.option("--decode-length", default=128,
              help="Events to decode inside the trace. Defaults to 128.")
def profile(model_type, output_dir, config_filepath, steps, decode_length):
    """Capture a torch.profiler trace of train steps and a decode.

    Runs the model from the config on synthetic batches drawn from --seed (no
    dataset needed) and writes a Chrome trace, OUTPUT_DIR/trace.json (open it
    in Perfetto or chrome://tracing). One untraced train step and decode run
    first, so the capture shows steady-state steps; the decode runs on the
    weights those steps trained, inside a "decode" span. On the card the
    trace holds the hand-written kernels' launches by name (the flash pair
    with ``use_pallas_attention``, the fused decode kernel). See also
    ``train --profile-dir`` for tracing a real training run.
    """
    import torch
    from torch.profiler import ProfilerActivity, record_function

    from composer_tpu_torch.train.generate import generate_ids

    config = config_module.get(config_filepath or get_default_config())
    trainer = _make_trainer(model_type, config)
    batch = get_batch_size(model_type, config)
    window = get_window_size(model_type, config)
    state = trainer.init_state(batch, window)
    carry = trainer.init_rnn_carry(batch)

    rng = np.random.default_rng(get_seed())
    vocab_size = trainer.model.config.vocab_size
    x = rng.integers(0, vocab_size, (batch, window)).astype(np.int32)
    y = rng.integers(0, vocab_size, (batch, window)).astype(np.int32)
    prompt = rng.integers(0, vocab_size, (1, 8)).astype(np.int32)
    generator = trainer.make_dropout_generator()

    def train_step(carry):
        metrics = trainer.train_step(state, x, y, generator, carry)
        return metrics, metrics.get("carry")

    def decode():
        # None: the module's own weights, so the decode sees what the steps
        # before it trained.
        return generate_ids(trainer.model, model_type, None, prompt,
                            length=decode_length, temperature=1.0, seed=get_seed())

    # Warm up outside the trace (allocations, the kernels' load); the loss's
    # host fetch waits for the step.
    metrics, carry = train_step(carry)
    float(metrics["loss"])
    decode()

    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as profiler:
        for index in range(steps):
            with record_function(f"train_step {index + 1}"):
                metrics, carry = train_step(carry)
        float(metrics["loss"])
        with record_function("decode"):
            decode()
    profiler.export_chrome_trace(str(output_dir / "trace.json"))
    logging.info(
        "Wrote a profiler trace of %d train steps + a %d-event decode to '%s'.",
        steps, decode_length, output_dir / "trace.json",
    )


def main():
    try:
        cli()
    except (ComposerError, NotImplementedError) as error:
        logging.error(str(error))
        raise SystemExit(1)


if __name__ == "__main__":
    main()
