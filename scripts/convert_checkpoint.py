"""Converts a training checkpoint between the JAX package and its PyTorch port.

    python scripts/convert_checkpoint.py to-torch <JAX logdir> <port logdir> [--step N]
    python scripts/convert_checkpoint.py to-jax <port logdir> <JAX logdir> [--step N]

Add ``--model-type music_rnn`` for a MusicRNN logdir (the default is
``transformer``).

A logdir is what ``composer train`` writes: ``config.yml`` and
``checkpoints/<step>``, an Orbax checkpoint in ``composer_tpu`` and a
``state.pt`` in ``composer_tpu_torch``. The script converts one step (the
newest unless ``--step`` names one) into the other package's layout under the
output logdir, keeping its step number, and copies ``config.yml`` across, so
that ``--restoredir <output logdir>`` works in the other CLI: ``generate``,
``evaluate``, ``serve``, and ``train`` to resume.

What carries over, exactly: the weights (``models/convert.py``:
``params_from_flax`` / ``params_to_flax``, MusicRNN's ``rnn_params_from_flax``
/ ``rnn_params_to_flax`` with its BatchNorm running statistics; Flax Dense
kernels are (in, out), torch's (out, in)), the Adam state (``count`` and the moments ``mu`` and
``nu``, through the same mapping; ``adam_state_from_optax`` /
``adam_state_to_optax``), and the step and epoch counters. What does not: the
JAX dropout key. Each package draws dropout from its own generator seeded by
``--seed`` (a JAX PRNG key in one, a ``torch.Generator`` in the other), and
neither stream can be replayed in the other, so a resumed run's dropout masks
differ between the packages.

Reading and writing Orbax needs JAX, which the port never imports; so the
bridge is this script, which imports both packages. JAX runs on the CPU
unless ``JAX_PLATFORMS`` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from collections import OrderedDict
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONFIG_FILE = "config.yml"


def _jax_trainer(config, model_type: str):
    """The JAX ``Trainer`` that ``composer train`` builds for ``config``: its
    optimizer chain (clipping, warmup) fixes the layout of the Adam state."""
    from composer_tpu.models import ModelType, create_model, get_learning_rate
    from composer_tpu.train.trainer import Trainer

    model_type = ModelType(model_type)
    model, _ = create_model(model_type, config)
    section = (config.music_rnn if model_type == ModelType.MUSIC_RNN
               else config.transformer).train
    return Trainer(model, model_type, get_learning_rate(model_type, config),
                   warmup_steps=int(section.get("warmup_steps", 0)),
                   gradient_clip_norm=float(section.get("gradient_clip_norm", 0.0)))


def _jax_template(config, model_type: str) -> dict:
    """A fresh JAX train state in state-dict form: the tree Orbax restores into."""
    import flax

    from composer_tpu.models import ModelType, get_batch_size, get_window_size

    trainer = _jax_trainer(config, model_type)
    state = trainer.init_state(get_batch_size(ModelType(model_type), config),
                               get_window_size(ModelType(model_type), config))
    return flax.serialization.to_state_dict(state)


def _port_model(logdir: Path, model_type: str):
    from composer_tpu_torch.config import get as port_config
    from composer_tpu_torch.models import ModelType, create_model

    model, _ = create_model(ModelType(model_type), port_config(logdir / CONFIG_FILE),
                            device="cpu")
    return model


def _port_state_dict(restored: dict, config):
    """The JAX state's ``params`` (and MusicRNN's ``extra_vars``) as the
    port's ``state_dict``."""
    from composer_tpu_torch.models import convert
    from composer_tpu_torch.models.music_rnn import MusicRNNConfig

    if isinstance(config, MusicRNNConfig):
        batch_stats = restored["extra_vars"].get("batch_stats") or None
        return convert.rnn_params_from_flax(restored["params"], batch_stats, config)
    return convert.params_from_flax(restored["params"], config)


def _set_counts(node, count) -> None:
    """Sets every optax ``count`` (Adam's, and a warmup schedule's, which
    counts the same updates) to ``count``."""
    if isinstance(node, dict):
        for key, value in node.items():
            if key == "count":
                node[key] = count
            else:
                _set_counts(value, count)


def to_torch(source: Path, target: Path, step=None, model_type: str = "transformer") -> int:
    """JAX logdir -> port logdir; returns the step converted."""
    import jax
    import numpy as np

    from composer_tpu.config import get as jax_config
    from composer_tpu.train.checkpoint import CheckpointManager, abstract_like
    from composer_tpu_torch.models import convert
    from composer_tpu_torch.train.checkpoint import CheckpointManager as PortCheckpoints

    template = _jax_template(jax_config(source / CONFIG_FILE), model_type)
    manager = CheckpointManager(source)
    try:
        step = manager.latest_step() if step is None else step
        restored = jax.device_get(manager.restore(abstract_like(template), step=step))
    finally:
        manager.close()

    model = _port_model(source, model_type)
    names = [name for name, _ in model.named_parameters()]
    model.load_state_dict(_port_state_dict(restored, model.config))
    state = {"step": int(np.asarray(restored["step"])),
             "epoch": int(np.asarray(restored["epoch"])),
             "params": OrderedDict(model.state_dict()),
             "opt_state": convert.adam_state_from_optax(restored["opt_state"], model.config,
                                                        names)}
    target.mkdir(parents=True, exist_ok=True)
    PortCheckpoints(target).save(step, state)
    shutil.copy2(source / CONFIG_FILE, target / CONFIG_FILE)
    return int(step)


def to_jax(source: Path, target: Path, step=None, model_type: str = "transformer") -> int:
    """Port logdir -> JAX logdir; returns the step converted."""
    import numpy as np

    from composer_tpu.config import get as jax_config
    from composer_tpu.train.checkpoint import CheckpointManager
    from composer_tpu_torch.models import convert
    from composer_tpu_torch.train.checkpoint import CheckpointManager as PortCheckpoints

    checkpoints = PortCheckpoints(source)
    step = checkpoints.latest_step() if step is None else step
    restored = checkpoints.restore(step, map_location="cpu")

    model = _port_model(source, model_type)
    names = [name for name, _ in model.named_parameters()]
    model.load_state_dict(restored["params"])  # checks names and shapes
    state = _jax_template(jax_config(source / CONFIG_FILE), model_type)
    if model_type == "music_rnn":
        state["params"], batch_stats = convert.rnn_params_to_flax(model.state_dict(),
                                                                  model.config)
        if batch_stats:
            state["extra_vars"]["batch_stats"] = batch_stats
    else:
        state["params"] = convert.params_to_flax(model.state_dict(), model.config)
    adam = convert.adam_state_to_optax(restored["opt_state"], model.config, names)
    _set_counts(state["opt_state"], adam["count"])
    convert.find_adam_state(state["opt_state"]).update(adam)
    state["step"] = np.asarray(int(restored["step"]), np.int32)
    state["epoch"] = np.asarray(int(restored["epoch"]), np.int32)

    target.mkdir(parents=True, exist_ok=True)
    manager = CheckpointManager(target)
    try:
        manager.save(step, state, wait=True)
    finally:
        manager.close()
    shutil.copy2(source / CONFIG_FILE, target / CONFIG_FILE)
    return int(step)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("direction", choices=("to-torch", "to-jax"))
    parser.add_argument("source", type=Path, help="the logdir to read")
    parser.add_argument("target", type=Path, help="the logdir to write")
    parser.add_argument("--step", type=int, default=None,
                        help="the checkpoint step to convert (default: the newest)")
    parser.add_argument("--model-type", choices=("transformer", "music_rnn"),
                        default="transformer", help="the model the logdir holds")
    args = parser.parse_args(argv)
    if not (args.source / CONFIG_FILE).exists():
        parser.error(f"'{args.source}' holds no {CONFIG_FILE}: not a training logdir")
    convert = to_torch if args.direction == "to-torch" else to_jax
    step = convert(args.source, args.target, args.step, args.model_type)
    print(f"converted step {step}: '{args.source}' -> '{args.target}' ({args.direction})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
