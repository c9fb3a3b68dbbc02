"""``import-checkpoint`` in the port (``train/import_reference.py``) against
the JAX package's importer, on small ``tf.train.Checkpoint`` files written
here with the reference's variable paths (TensorFlow reads and writes them;
the port imports it only inside ``read_reference_checkpoint``).

On the same checkpoint the port's imported state equals the JAX importer's
bit for bit through the weight bridge, for the Transformer and for MusicRNN;
the errors are the JAX importer's; the CLI command writes its config
snapshot only after a successful import.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
import tensorflow as tf  # noqa: E402

import composer_tpu.config as jax_config_module  # noqa: E402
from composer_tpu.models import ModelType as JaxModelType  # noqa: E402
from composer_tpu.models.music_rnn import MusicRNN as JaxMusicRNN  # noqa: E402
from composer_tpu.models.music_rnn import MusicRNNConfig as JaxRNNConfig  # noqa: E402
from composer_tpu.models.transformer import Transformer as JaxTransformer  # noqa: E402
from composer_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from composer_tpu.train import import_reference as jax_import  # noqa: E402
from composer_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from composer_tpu_torch import cli as port_cli  # noqa: E402
from composer_tpu_torch.config import get_default  # noqa: E402
from composer_tpu_torch.exceptions import CheckpointError  # noqa: E402
from composer_tpu_torch.models import ModelType  # noqa: E402
from composer_tpu_torch.models.convert import params_to_flax, rnn_params_to_flax  # noqa: E402
from composer_tpu_torch.models.music_rnn import MusicRNN, MusicRNNConfig  # noqa: E402
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig  # noqa: E402
from composer_tpu_torch.train import import_reference  # noqa: E402
from composer_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from composer_tpu_torch.train.trainer import Trainer  # noqa: E402

VOCAB, EMBED, WINDOW, LAYERS, HEADS = 30, 16, 16, 2, 2
RNN_SIZES = (24, 24)


def _tf_tree(tree):
    """A nested dict of arrays as nested trackables: dicts with int keys
    become lists (the reference's ``decoder_blocks/0`` paths)."""
    if isinstance(tree, dict):
        if all(isinstance(key, int) for key in tree):
            return [_tf_tree(tree[key]) for key in sorted(tree)]
        return tf.train.Checkpoint(**{key: _tf_tree(value) for key, value in tree.items()})
    return tf.Variable(tree)


def _save(directory, model_tree, step=41, epoch=7):
    root = tf.train.Checkpoint(step=tf.Variable(step), epoch=tf.Variable(epoch),
                               model=_tf_tree(model_tree))
    tf.train.CheckpointManager(root, str(directory), max_to_keep=1).save()
    return directory


def _normal(rng, *shape):
    return rng.normal(0, 0.2, shape).astype(np.float32)


def _transformer_tree(seed=0, rel_rows=WINDOW):
    """The reference Transformer's variables (Conv1D kernels ``(in, out)``,
    biases ``(1, out)``, the relative table ``(H, rows, D)``)."""
    rng = np.random.default_rng(seed)
    blocks = {}
    for layer in range(LAYERS):
        blocks[layer] = {
            "ln_1": {"gamma": _normal(rng, EMBED), "beta": _normal(rng, EMBED)},
            "ln_2": {"gamma": _normal(rng, EMBED), "beta": _normal(rng, EMBED)},
            "attn": {"c_attn": {"weight": _normal(rng, EMBED, 3 * EMBED),
                                "bias": _normal(rng, 1, 3 * EMBED)},
                     "c_proj": {"weight": _normal(rng, EMBED, EMBED),
                                "bias": _normal(rng, 1, EMBED)},
                     "E": _normal(rng, HEADS, rel_rows, EMBED // HEADS)},
            "mlp": {"c_fc": {"weight": _normal(rng, EMBED, 4 * EMBED),
                             "bias": _normal(rng, 1, 4 * EMBED)},
                    "c_proj": {"weight": _normal(rng, 4 * EMBED, EMBED),
                               "bias": _normal(rng, 1, EMBED)}},
        }
    return {"wte": {"weight": _normal(rng, VOCAB, EMBED)},
            "wpe": {"embeddings": _normal(rng, WINDOW, EMBED)},
            "ln_f": {"gamma": _normal(rng, EMBED), "beta": _normal(rng, EMBED)},
            "decoder_blocks": blocks}


def _rnn_tree(seed=0, vocab=VOCAB, embed=EMBED, sizes=RNN_SIZES):
    """The reference MusicRNN's variables (Keras LSTM kernels packed
    ``[i, f, g, o]`` on the last axis, one bias; BatchNorm moving
    statistics)."""
    rng = np.random.default_rng(seed)
    lstm, norms, width = {}, {}, embed
    for index, hidden in enumerate(sizes):
        lstm[index] = {"cell": {"kernel": _normal(rng, width, 4 * hidden),
                                "recurrent_kernel": _normal(rng, hidden, 4 * hidden),
                                "bias": _normal(rng, 4 * hidden)}}
        norms[index] = {"gamma": _normal(rng, hidden), "beta": _normal(rng, hidden),
                        "moving_mean": _normal(rng, hidden),
                        "moving_variance": rng.uniform(0.5, 2, hidden).astype(np.float32)}
        width = hidden
    return {"embedding_layer": {"embeddings": _normal(rng, vocab, embed)},
            "lstm_layers": lstm, "normalization_layers": norms,
            "output_layer": {"kernel": _normal(rng, width, vocab), "bias": _normal(rng, vocab)}}


def _transformer_kwargs():
    return dict(vocab_size=VOCAB, embed_dim=EMBED, window_size=WINDOW, num_layers=LAYERS,
                num_heads=HEADS, use_relative_attention=True)


def _rnn_kwargs():
    return dict(vocab_size=VOCAB, embed_dim=EMBED, layer_sizes=RNN_SIZES,
                dropout_rates=(0.0, 0.0))


def _port_trainer(model_type):
    model = (Transformer(TransformerConfig(**_transformer_kwargs()))
             if model_type == ModelType.TRANSFORMER else MusicRNN(MusicRNNConfig(**_rnn_kwargs())))
    return Trainer(model, model_type, 1e-3, device="cpu")


def _jax_trainer(model_type):
    model = (JaxTransformer(JaxConfig(**_transformer_kwargs()))
             if model_type == JaxModelType.TRANSFORMER
             else JaxMusicRNN(JaxRNNConfig(**_rnn_kwargs())))
    return JaxTrainer(model, model_type, 1e-3)


def _yaml(get_default_config):
    """A default YAML config of either package cut to the tiny models'
    window, batch 1 (the shapes the trainers initialise at)."""
    config = get_default_config()
    for section in (config.transformer, config.music_rnn):
        section.model["window_size"] = WINDOW
        section.train["batch_size"] = 1
    return config


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, expected):
    got, expected = _flat(got), _flat(expected)
    assert got.keys() == expected.keys()
    for name, value in expected.items():
        assert got[name].dtype == value.dtype and np.array_equal(got[name], value), name


@pytest.mark.parametrize("kind", ["transformer", "music_rnn"])
def test_import_equals_the_jax_importer_bit_for_bit(kind, tmp_path):
    tree = _transformer_tree() if kind == "transformer" else _rnn_tree()
    checkpoint = _save(tmp_path / "reference", tree)
    jax_state = jax_import.import_reference_checkpoint(
        JaxModelType(kind), checkpoint, tmp_path / "jax", _yaml(jax_config_module.get_default),
        trainer=_jax_trainer(JaxModelType(kind)))
    trainer = _port_trainer(ModelType(kind))
    state = import_reference.import_reference_checkpoint(
        ModelType(kind), checkpoint, tmp_path / "port", _yaml(get_default), trainer=trainer)

    assert (state.step, state.epoch) == (41, 7) == (int(jax_state.step), int(jax_state.epoch))
    config = state.model.config
    if kind == "transformer":
        _assert_trees_equal(params_to_flax(state.model.state_dict(), config),
                            jax.device_get(jax_state.params))
    else:
        params, stats = rnn_params_to_flax(state.model.state_dict(), config)
        _assert_trees_equal(params, jax.device_get(jax_state.params))
        _assert_trees_equal(stats, jax.device_get(jax_state.extra_vars["batch_stats"]))
    # The Adam state starts fresh; the checkpoint is the port's, at step - 1.
    assert state.optimizer.count == 0
    assert not any(m.any() for m in state.optimizer.mu + state.optimizer.nu)
    assert CheckpointManager(tmp_path / "port").steps() == [40]
    restored = _port_trainer(ModelType(kind)).restore(tmp_path / "port", 1, WINDOW)
    assert (restored.step, restored.epoch) == (41, 7)
    for name, tensor in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[name], tensor), name


def test_step_one_is_saved_as_step_one(tmp_path):
    checkpoint = _save(tmp_path / "reference", _rnn_tree(), step=1, epoch=1)
    import_reference.import_reference_checkpoint(
        ModelType.MUSIC_RNN, checkpoint, tmp_path / "port", _yaml(get_default),
        trainer=_port_trainer(ModelType.MUSIC_RNN))
    assert CheckpointManager(tmp_path / "port").steps() == [1]


def _drop(tree, *path):
    node = tree
    for key in path[:-1]:
        node = node[key]
    del node[path[-1]]
    return tree


@pytest.mark.parametrize("kind, tree, message", [
    ("music_rnn", lambda: _drop(_rnn_tree(), "output_layer", "bias"),
     "missing variable 'model/output_layer/bias'"),
    ("music_rnn", lambda: _drop(_rnn_tree(), "normalization_layers", 1, "moving_variance"),
     "missing variable 'model/normalization_layers/1/moving_variance'"),
    ("transformer", lambda: _drop(_transformer_tree(), "decoder_blocks", 0, "mlp", "c_fc",
                                  "weight"),
     "missing variable 'model/decoder_blocks/0/mlp/c_fc/weight'"),
    ("music_rnn", lambda: _rnn_tree(sizes=(20, 24)),
     "LSTM layer 0 has 20 units in the checkpoint but 24 in the config"),
    ("transformer", lambda: _transformer_tree(rel_rows=2 * WINDOW), "trained at batch > 1"),
    ("transformer", lambda: _drop(_transformer_tree(), "decoder_blocks", 1),
     "fewer decoder blocks"),
])
def test_import_errors_match_the_jax_importer(kind, tree, message, tmp_path):
    checkpoint = _save(tmp_path / "reference", tree())
    with pytest.raises(CheckpointError, match=message):
        import_reference.import_reference_checkpoint(
            ModelType(kind), checkpoint, tmp_path / "port", _yaml(get_default),
            trainer=_port_trainer(ModelType(kind)))
    with pytest.raises(Exception, match=message):
        jax_import.import_reference_checkpoint(
            JaxModelType(kind), checkpoint, tmp_path / "jax", _yaml(jax_config_module.get_default),
            trainer=_jax_trainer(JaxModelType(kind)))
    assert not (tmp_path / "port").exists()


def test_reading_needs_tensorflow_and_a_checkpoint(tmp_path, monkeypatch):
    with pytest.raises(CheckpointError, match="does not contain a readable TensorFlow"):
        import_reference.read_reference_checkpoint(tmp_path)
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # import tensorflow fails
    with pytest.raises(CheckpointError, match="requires TensorFlow"):
        import_reference.read_reference_checkpoint(tmp_path)


# The music_rnn section of tests/test_cli.py's tiny config (vocab 390 from
# the default codec settings).
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


def _invoke(*args):
    return CliRunner().invoke(port_cli.cli, [str(a) for a in args], catch_exceptions=False)


def test_cli_imports_then_generates(tmp_path):
    config = tmp_path / "config.yml"
    config.write_text(TINY_CONFIG)
    checkpoint = _save(tmp_path / "reference", _rnn_tree(vocab=390, sizes=(16,)), step=12)
    out = tmp_path / "imported"
    result = _invoke("--device", "cpu", "import-checkpoint", "music_rnn", checkpoint, out,
                     "-c", config)
    assert result.exit_code == 0, result.output
    assert (out / "config.yml").exists()
    assert CheckpointManager(out).steps() == [11]
    result = _invoke("--seed", 3, "--device", "cpu", "generate", "music_rnn", out,
                     tmp_path / "out.mid", "-l", 8)
    assert result.exit_code == 0, result.output
    assert (tmp_path / "out.mid").stat().st_size > 0


def test_cli_failed_import_leaves_no_config_snapshot(tmp_path):
    """A failed import must not leave a config.yml that a later restore
    would mistake for a trained model's logdir."""
    bogus = tmp_path / "not_a_checkpoint"
    bogus.mkdir()
    out = tmp_path / "imported"
    result = CliRunner().invoke(
        port_cli.cli, ["--device", "cpu", "import-checkpoint", "transformer", str(bogus),
                       str(out)])
    assert result.exit_code != 0
    assert not (out / "config.yml").exists()
    # A checkpoint of the other model type fails the same way.
    config = tmp_path / "config.yml"
    config.write_text(TINY_CONFIG)
    checkpoint = _save(tmp_path / "reference", _rnn_tree(vocab=390, sizes=(16,)))
    result = CliRunner().invoke(
        port_cli.cli, ["--device", "cpu", "import-checkpoint", "transformer", str(checkpoint),
                       str(out), "-c", str(config)])
    assert result.exit_code != 0
    assert not (out / "config.yml").exists()
