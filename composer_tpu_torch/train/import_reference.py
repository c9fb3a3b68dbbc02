"""Import trained checkpoints from the upstream TF reference: port of
``composer_tpu/train/import_reference.py``.

A ``tf.train.Checkpoint(step, epoch, optimizer, model)`` saved by the
reference's train loops (reference transformer.py:890-900,
music_rnn.py:199-209) is read variable by variable with TensorFlow's
checkpoint reader (TensorFlow is needed only for this command, and imported
only inside ``read_reference_checkpoint``), mapped onto the Flax trees of
the JAX package, carried onto the port's ``state_dict`` by
``models/convert.py``, and saved in the port's checkpoint layout
(``train/checkpoint.py``), after which ``generate``, ``evaluate``,
``serve`` and ``train --restoredir`` take the log directory.

What transfers: the model weights, exactly (the reference's Conv1D already
stores ``(in, out)`` kernels), MusicRNN's BatchNorm moving statistics, and
the step and epoch counters. The Adam slots do not: the optimizer starts
fresh, as in the JAX package.

Relative attention: the reference couples its E table to ``batch * seq``
(reference transformer.py:285), so only checkpoints trained at batch 1 (or
with relative attention off, the reference's default) have a well-defined
per-position table; any other is refused with the reason.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

import numpy as np

from composer_tpu_torch.exceptions import CheckpointError
from composer_tpu_torch.models import ModelType

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def read_reference_checkpoint(checkpoint_dir) -> Dict[str, np.ndarray]:
    """Reads every variable of the latest reference checkpoint into a dict
    keyed by object path (``model/wte/weight`` style, suffix stripped)."""
    try:
        import tensorflow as tf  # only this command needs TensorFlow
    except Exception as error:
        raise CheckpointError(
            "Importing a reference checkpoint requires TensorFlow (used only to read "
            f"the checkpoint): {error}"
        ) from None

    checkpoint_dir = str(checkpoint_dir)
    latest = tf.train.latest_checkpoint(checkpoint_dir)
    if latest is None:
        # Accept a checkpoint prefix as well as a directory.
        latest = checkpoint_dir
    try:
        reader = tf.train.load_checkpoint(latest)
        shape_map = reader.get_variable_to_shape_map()
    except Exception as error:
        raise CheckpointError(
            f"'{checkpoint_dir}' does not contain a readable TensorFlow checkpoint: {error}"
        ) from None

    variables = {}
    for name in shape_map:
        if name.endswith(_SUFFIX):
            variables[name[: -len(_SUFFIX)]] = reader.get_tensor(name)
    if not any(key.startswith("model/") for key in variables):
        raise CheckpointError(
            f"Checkpoint at '{checkpoint_dir}' has no 'model/' variables: not a reference "
            "composer checkpoint."
        )
    return variables


def _get(variables, name):
    try:
        return np.asarray(variables[name])
    except KeyError:
        raise CheckpointError(
            f"Reference checkpoint is missing variable '{name}': was it saved by a "
            "different model type or architecture?"
        ) from None


def reference_to_transformer_params(variables, config) -> dict:
    """Maps reference Transformer checkpoint variables onto the Flax
    parameter tree (the JAX package's layout; reference Conv1D kernels are
    ``(in, out)``, so nothing is transposed)."""
    params = {
        "wte": _get(variables, "model/wte/weight"),
        "wpe": _get(variables, "model/wpe/embeddings"),
        "ln_f": {
            "scale": _get(variables, "model/ln_f/gamma"),
            "bias": _get(variables, "model/ln_f/beta"),
        },
    }
    vocab, embed = params["wte"].shape
    if vocab != config.vocab_size or embed != config.embed_dim:
        raise CheckpointError(
            f"Checkpoint model shape (vocab {vocab}, embed {embed}) does not match the "
            f"config (vocab {config.vocab_size}, embed {config.embed_dim}); import with the "
            "config the reference model was trained with."
        )
    window = params["wpe"].shape[0]
    if window != config.window_size:
        raise CheckpointError(
            f"Checkpoint window size {window} does not match the config's "
            f"{config.window_size}."
        )

    for layer in range(config.num_layers):
        prefix = f"model/decoder_blocks/{layer}"
        if f"{prefix}/ln_1/gamma" not in variables:
            raise CheckpointError(
                f"Checkpoint has fewer decoder blocks than the config's {config.num_layers}."
            )

        def dense(name):
            return {"kernel": _get(variables, f"{prefix}/{name}/weight"),
                    "bias": _get(variables, f"{prefix}/{name}/bias").reshape(-1)}

        attn = {"c_attn": dense("attn/c_attn"), "c_proj": dense("attn/c_proj")}
        if config.use_relative_attention:
            rel = _get(variables, f"{prefix}/attn/E")
            if rel.shape[1] != config.window_size:
                raise CheckpointError(
                    "The reference couples relative-attention E to batch*sequence (its "
                    f"transformer.py:285); this checkpoint's E has {rel.shape[1]} rows but "
                    f"the window is {config.window_size}, so it was trained at batch > 1 "
                    "and has no well-defined per-position table to import."
                )
            attn["rel_embedding"] = rel
        params[f"h_{layer + 1}"] = {
            "ln_1": {"scale": _get(variables, f"{prefix}/ln_1/gamma"),
                     "bias": _get(variables, f"{prefix}/ln_1/beta")},
            "ln_2": {"scale": _get(variables, f"{prefix}/ln_2/gamma"),
                     "bias": _get(variables, f"{prefix}/ln_2/beta")},
            "attn": attn,
            "mlp": {"c_fc": dense("mlp/c_fc"), "c_proj": dense("mlp/c_proj")},
        }
    if f"model/decoder_blocks/{config.num_layers}/ln_1/gamma" in variables:
        raise CheckpointError(
            f"Checkpoint has more decoder blocks than the config's {config.num_layers}."
        )
    return params


def reference_to_rnn_variables(variables, config) -> tuple:
    """Maps reference MusicRNN checkpoint variables onto the Flax
    ``(params, batch_stats)``. Keras packs the LSTM gates [i, f, g, o] along
    the last axis with one bias; Flax's ``OptimizedLSTMCell`` keeps per-gate
    kernels, the bias on the hidden side."""
    params = {
        "embedding": {"embedding": _get(variables, "model/embedding_layer/embeddings")},
        "output": {
            "kernel": _get(variables, "model/output_layer/kernel"),
            "bias": _get(variables, "model/output_layer/bias"),
        },
    }
    batch_stats = {}
    for index, hidden in enumerate(config.layer_sizes):
        prefix = f"model/lstm_layers/{index}/cell"
        kernel = _get(variables, f"{prefix}/kernel")
        recurrent = _get(variables, f"{prefix}/recurrent_kernel")
        bias = _get(variables, f"{prefix}/bias")
        if kernel.shape[1] != 4 * hidden:
            raise CheckpointError(
                f"LSTM layer {index} has {kernel.shape[1] // 4} units in the checkpoint but "
                f"{hidden} in the config."
            )
        cell = {}
        for gate_index, gate in enumerate(["i", "f", "g", "o"]):
            columns = slice(gate_index * hidden, (gate_index + 1) * hidden)
            cell[f"i{gate}"] = {"kernel": kernel[:, columns]}
            cell[f"h{gate}"] = {"kernel": recurrent[:, columns], "bias": bias[columns]}
        params[f"OptimizedLSTMCell_{index}"] = cell

        norm_prefix = f"model/normalization_layers/{index}"
        if config.use_batch_normalization:
            params[f"batch_norm_{index}"] = {
                "scale": _get(variables, f"{norm_prefix}/gamma"),
                "bias": _get(variables, f"{norm_prefix}/beta"),
            }
            batch_stats[f"batch_norm_{index}"] = {
                "mean": _get(variables, f"{norm_prefix}/moving_mean"),
                "var": _get(variables, f"{norm_prefix}/moving_variance"),
            }
    return params, batch_stats


def _cast_like(template, values):
    """Casts the imported arrays to the template's dtypes, refusing a tree
    whose keys differ from the template's."""
    if isinstance(template, dict):
        missing = set(template) - set(values)
        extra = set(values) - set(template)
        if missing or extra:
            raise CheckpointError(
                f"Imported parameter tree mismatch: missing {sorted(missing)}, "
                f"unexpected {sorted(extra)}."
            )
        return {key: _cast_like(template[key], values[key]) for key in template}
    return np.asarray(values, dtype=np.asarray(template).dtype)


def import_reference_checkpoint(model_type: ModelType, checkpoint_dir, logdir, config,
                                trainer=None):
    """Converts a reference checkpoint into a checkpoint of the port at
    ``logdir``, saved as step ``max(step - 1, 1)``; returns the imported
    ``TrainState``. ``trainer`` may be given (tests); otherwise the CLI's
    is built from the config, on the CLI's device."""
    from composer_tpu_torch.models import convert, get_batch_size, get_window_size
    from composer_tpu_torch.train.checkpoint import CheckpointManager

    variables = read_reference_checkpoint(checkpoint_dir)
    if trainer is None:
        from composer_tpu_torch.cli import _make_trainer  # late: the CLI imports this module

        trainer = _make_trainer(model_type, config)

    state = trainer.init_state(get_batch_size(model_type, config),
                               get_window_size(model_type, config))
    model_config = state.model.config
    # The model's own tree is the template: its keys validate the import
    # and its dtypes are the ones the weights are cast to.
    if model_type == ModelType.TRANSFORMER:
        template = convert.params_to_flax(state.model.state_dict(), model_config)
        params = _cast_like(template, reference_to_transformer_params(variables, model_config))
        imported = convert.params_from_flax(params, model_config)
    else:
        template, _ = convert.rnn_params_to_flax(state.model.state_dict(), model_config)
        params, batch_stats = reference_to_rnn_variables(variables, model_config)
        imported = convert.rnn_params_from_flax(_cast_like(template, params),
                                                batch_stats or None, model_config)
    try:
        state.model.load_state_dict(imported)
    except RuntimeError as error:
        raise CheckpointError(f"Imported weights do not fit the model: {error}") from None

    step = int(np.asarray(variables.get("step", 1)))
    state.step = step
    state.epoch = int(np.asarray(variables.get("epoch", 1)))
    state.optimizer = trainer.optimizer.init(state.model.parameters())

    CheckpointManager(Path(logdir)).save(max(step - 1, 1), state.state_dict())
    logging.info(
        "Imported reference checkpoint (step=%d, epoch=%d) into '%s'. Optimizer state does "
        "not transfer: resumed training restarts Adam moments.", step, state.epoch, logdir,
    )
    return state
