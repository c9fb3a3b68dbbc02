"""Composer in PyTorch: the decode path of ``composer_tpu`` for NVIDIA Hopper.

Module names follow ``composer_tpu`` so each piece has an obvious
counterpart. The framework-free layers (MIDI codec, config, vocabulary) are
imported from ``composer_tpu`` directly; nothing here imports JAX.
"""

__version__ = "0.1.0"
