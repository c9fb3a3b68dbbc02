"""Model registry and factory: port of ``composer_tpu/models/__init__.py``.

``ModelType``, ``EventEncodingType``, ``get_event_vocab_size``,
``get_batch_size``, ``get_learning_rate`` and ``get_window_size`` are the
port's own copies (``composer_tpu/models/__init__.py:18-33``, ``:131-143``).
"""

from __future__ import annotations

import logging
from enum import Enum, unique

from composer_tpu_torch.exceptions import InvalidParameterError
from composer_tpu_torch.midi.vocab import vocabulary_from_config

__all__ = ["EventEncodingType", "ModelType", "create_model", "get_batch_size",
           "get_event_vocab_size", "get_learning_rate", "get_window_size"]


@unique
class ModelType(Enum):
    MUSIC_RNN = "music_rnn"
    TRANSFORMER = "transformer"


@unique
class EventEncodingType(Enum):
    """How events are fed to the network (models/__init__.py:95-107)."""

    INTEGER = 0
    ONE_HOT = 1


def get_event_vocab_size(config) -> int:
    return vocabulary_from_config(config).size


def _compute_dtype(model_section, device):
    """bfloat16 on a CUDA device when the config asks for mixed precision,
    float32 elsewhere (CPU runs stay float32, as in the JAX package)."""
    import torch

    if torch.device(device).type != "cuda":
        return torch.float32
    if bool(model_section.get("mixed_precision", False)):
        logging.getLogger(__name__).info("mixed_precision: bfloat16 compute enabled")
        return torch.bfloat16
    return torch.float32


def create_model(model_type: ModelType, config, device="cuda", **overrides):
    """Builds the module for ``model_type`` from the YAML config, on the card
    unless ``device`` names another (``device="cpu"`` for the CPU).

    Returns ``(module, vocab_size)``. Parameters are initialised with the
    Flax initializers from torch's default generator; load real weights with
    ``load_state_dict``.
    """
    from composer_tpu_torch.models.music_rnn import MusicRNN, MusicRNNConfig
    from composer_tpu_torch.models.transformer import Transformer, TransformerConfig

    vocab_size = get_event_vocab_size(config)
    if model_type == ModelType.TRANSFORMER:
        section = config.transformer.model
        overrides.setdefault("dtype", _compute_dtype(section, device))
        model_config = TransformerConfig(
            vocab_size=vocab_size,
            embed_dim=int(section.embedding_size),
            window_size=int(section.window_size),
            num_layers=int(section.decoder_layers_count),
            num_heads=int(section.attention_head_count),
            use_relative_attention=bool(section.use_relative_attention),
            attention_dropout_rate=float(section.attention_dropout_rate),
            residual_dropout_rate=float(section.residual_dropout_rate),
            layer_norm_epsilon=float(section.layer_normalization_epsilon),
            scale_attention=bool(section.scale_attention),
            initializer_mean=float(section.initializer_mean),
            initializer_stddev=float(section.initializer_stddev),
            use_layer_norm=bool(section.use_layer_normalization),
            band_block_size=int(section.get("band_block_size", 128)),
            attention_chunk_size=int(section.get("attention_chunk_size", 0)),
            remat=bool(section.get("remat", False)),
            use_pallas_attention=bool(section.get("use_pallas_attention", False)),
            **overrides,
        )
        return Transformer(model_config, device=device), vocab_size

    if model_type == ModelType.MUSIC_RNN:
        section = config.music_rnn.model
        layer_sizes = section.lstm_layer_sizes
        if not isinstance(layer_sizes, (list, tuple)):
            layer_sizes = [int(layer_sizes)] * int(section.lstm_layers_count)
        dropout = section.lstm_dropout_probability
        if not isinstance(dropout, (list, tuple)):
            dropout = [float(dropout)] * int(section.lstm_layers_count)
        overrides.setdefault("dtype", _compute_dtype(section, device))
        model_config = MusicRNNConfig(
            vocab_size=vocab_size,
            embed_dim=int(section.embedding_size),
            layer_sizes=tuple(int(s) for s in layer_sizes),
            dropout_rates=tuple(float(d) for d in dropout),
            use_batch_normalization=bool(section.use_batch_normalization),
            **overrides,
        )
        return MusicRNN(model_config, device=device), vocab_size

    raise InvalidParameterError(f"Unrecognized model type: '{model_type}'.")


def get_batch_size(model_type: ModelType, config) -> int:
    section = config.music_rnn if model_type == ModelType.MUSIC_RNN else config.transformer
    return int(section.train.batch_size)


def get_learning_rate(model_type: ModelType, config) -> float:
    section = config.music_rnn if model_type == ModelType.MUSIC_RNN else config.transformer
    return float(section.train.learning_rate)


def get_window_size(model_type: ModelType, config) -> int:
    section = config.music_rnn if model_type == ModelType.MUSIC_RNN else config.transformer
    return int(section.model.window_size)
