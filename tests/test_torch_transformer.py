"""The PyTorch port's Transformer, attention and weight bridge against the
JAX package, on the same weights (f32, CPU)."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composer_tpu.models.transformer import Transformer as JaxTransformer
from composer_tpu.models.transformer import TransformerConfig as JaxConfig
from composer_tpu.models.transformer import init_cache as jax_init_cache
from composer_tpu_torch.models.convert import params_from_flax, params_to_flax
from composer_tpu_torch.models.transformer import Transformer, TransformerConfig, init_cache

REPO = Path(__file__).resolve().parents[1]
# f32 tolerance of tests/test_torch_parity.py: the two frameworks sum in
# different orders.
TOL = 2e-4


def _pair(use_relative, window=16, vocab=97):
    kwargs = dict(
        vocab_size=vocab, embed_dim=32, window_size=window, num_layers=2, num_heads=4,
        use_relative_attention=use_relative, attention_dropout_rate=0.0,
        residual_dropout_rate=0.0, initializer_stddev=0.1,
    )
    jax_model = JaxTransformer(JaxConfig(**kwargs))
    params = jax.device_get(jax_model.init_params(jax.random.PRNGKey(3), 1, 8))
    config = TransformerConfig(**kwargs)
    model = Transformer(config)
    model.load_state_dict(params_from_flax(params, config))
    return jax_model, params, model


@pytest.mark.parametrize("use_relative", [False, True])
def test_uncached_logits_match_flax(use_relative):
    jax_model, params, model = _pair(use_relative)
    tokens = np.random.default_rng(0).integers(0, 97, (2, 12)).astype(np.int32)
    expected, _ = jax_model.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        logits, cache = model(torch.as_tensor(tokens).long())
    assert cache is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(expected), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_relative", [False, True])
def test_prefill_then_decode_logits_match_flax(use_relative):
    """A cached prefill followed by one-token decode steps, including steps
    past the window (positions clamp, out-of-table distances get no bias)."""
    jax_model, params, model = _pair(use_relative, window=8)
    tokens = np.random.default_rng(1).integers(0, 97, (2, 12)).astype(np.int32)
    # Under jit, as in generation, JAX clamps the positions past the window.
    apply = jax.jit(jax_model.apply)
    jcache = jax_init_cache(jax_model.config, 2, 16)
    cache = init_cache(model.config, 2, 16)
    expected, jcache = apply({"params": params}, jnp.asarray(tokens[:, :5]), jcache)
    with torch.no_grad():
        logits, cache = model(torch.as_tensor(tokens[:, :5]).long(), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(expected), rtol=TOL, atol=TOL)
    for step in range(5, 12):
        expected, jcache = apply(
            {"params": params}, jnp.asarray(tokens[:, step:step + 1]), jcache
        )
        with torch.no_grad():
            logits, cache = model(torch.as_tensor(tokens[:, step:step + 1]).long(), cache)
        assert cache["index"] == step + 1
        np.testing.assert_allclose(
            logits.numpy(), np.asarray(expected), rtol=TOL, atol=TOL, err_msg=f"step {step}"
        )
    for layer, jlayer in zip(cache["layers"], jcache["layers"]):
        np.testing.assert_allclose(layer["k"].numpy(), np.asarray(jlayer["k"]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_relative", [False, True])
def test_weight_bridge_round_trip_is_exact(use_relative):
    _, params, model = _pair(use_relative)
    back = params_to_flax(params_from_flax(params, model.config), model.config)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        assert node.dtype == np.asarray(leaf).dtype
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=str(path))
    # The state_dict carries exactly the module's parameter names and shapes.
    state = params_from_flax(params, model.config)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()
    }


def test_create_model_from_default_config():
    from composer_tpu_torch.config import get_default
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.models import create_model

    model, vocab = create_model(ModelType.TRANSFORMER, get_default(), device="cpu")
    config = model.config
    assert (vocab, config.embed_dim, config.num_layers, config.num_heads) == (390, 256, 8, 16)
    assert config.window_size == 1024 and config.head_dim == 16
    assert config.dtype == torch.float32  # CPU stays float32


def test_create_model_defaults_to_the_card():
    """The factory builds on CUDA unless the caller asks for the CPU: without
    a card the default raises instead of quietly building on the CPU."""
    from composer_tpu_torch.config import get_default
    from composer_tpu_torch.models import ModelType
    from composer_tpu_torch.models import create_model

    if torch.cuda.is_available():
        model, _ = create_model(ModelType.TRANSFORMER, get_default())
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            create_model(ModelType.TRANSFORMER, get_default())


def test_port_imports_no_jax():
    """No module of the port (the CLI and the modules it needs included),
    and neither ``chip_smoke`` nor ``scripts/spec_acceptance.py`` (imported
    as modules, without running ``main``), loads JAX or anything of the JAX
    package ``composer_tpu`` (nor TensorFlow, which only ``import-checkpoint``
    loads, inside the call). conftest imports JAX here, so the check runs in a fresh interpreter."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import composer_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(composer_tpu_torch.__path__, "
        "'composer_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "importlib.import_module('chip_smoke')\n"
        "spec = importlib.util.spec_from_file_location('spec_acceptance', "
        "'scripts/spec_acceptance.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'composer_tpu', 'tensorflow'))\n"
        "missing = {'composer_tpu_torch.ops.decode_kernel_spec', "
        "'composer_tpu_torch.ops.decode_kernel_segmented', 'composer_tpu_torch.serving', "
        "'composer_tpu_torch.midi.midi_io', 'composer_tpu_torch.cli', "
        "'composer_tpu_torch.utils', 'composer_tpu_torch.logging_utils', "
        "'composer_tpu_torch.click_utils', 'composer_tpu_torch.midi.fast_encode', "
        "'composer_tpu_torch.midi.serialization', 'composer_tpu_torch.data.preprocess', "
        "'composer_tpu_torch.models.music_rnn', 'composer_tpu_torch.train.import_reference', "
        "'composer_tpu_torch.bench'} "
        "- set(names)\n"
        "print(len(names), 'modules;', bad, 'missing', missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 20 else 0)\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert result.returncode == 0, result.stdout + result.stderr
