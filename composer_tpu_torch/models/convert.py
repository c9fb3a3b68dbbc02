"""Weight bridge between the Flax parameter tree and the port's ``state_dict``.

Flax Dense kernels are ``(in, out)``; ``nn.Linear.weight`` is ``(out, in)``,
so matmul kernels are transposed on the way through. LayerNorm ``scale`` is
the torch ``weight``. ``rel_embedding`` keeps its ``(H, W, D)`` layout. The
mapping is exact: ``params_to_flax(params_from_flax(p, c), c)`` returns ``p``
bit for bit.

The optimizer state goes through the same mapping: optax's Adam moments
``mu`` and ``nu`` are trees shaped like the params, and the port's
``Adam.state_dict()`` holds them as lists in the model's parameter order
(``adam_state_from_optax``, ``adam_state_to_optax``). numpy only: the
checkpoint bridge, ``scripts/convert_checkpoint.py``, reads and writes the
Orbax side.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

# (flax path inside a block, torch name inside a block, transposed?)
_BLOCK_LEAVES = (
    (("ln_1", "scale"), "ln_1.weight", False),
    (("ln_1", "bias"), "ln_1.bias", False),
    (("attn", "c_attn", "kernel"), "attn.c_attn.weight", True),
    (("attn", "c_attn", "bias"), "attn.c_attn.bias", False),
    (("attn", "c_proj", "kernel"), "attn.c_proj.weight", True),
    (("attn", "c_proj", "bias"), "attn.c_proj.bias", False),
    (("attn", "rel_embedding"), "attn.rel_embedding", False),
    (("ln_2", "scale"), "ln_2.weight", False),
    (("ln_2", "bias"), "ln_2.bias", False),
    (("mlp", "c_fc", "kernel"), "mlp.c_fc.weight", True),
    (("mlp", "c_fc", "bias"), "mlp.c_fc.bias", False),
    (("mlp", "c_proj", "kernel"), "mlp.c_proj.weight", True),
    (("mlp", "c_proj", "bias"), "mlp.c_proj.bias", False),
)


def _leaves(config):
    """(flax path, torch name, transposed?) for every parameter of ``config``."""
    yield ("wte",), "wte", False
    yield ("wpe",), "wpe", False
    for layer in range(config.num_layers):
        block = f"h_{layer + 1}"
        for path, name, transposed in _BLOCK_LEAVES:
            if path[0] in ("ln_1", "ln_2") and not config.use_layer_norm:
                continue
            if path[-1] == "rel_embedding" and not config.use_relative_attention:
                continue
            yield (block, *path), f"{block}.{name}", transposed
    yield ("ln_f", "scale"), "ln_f.weight", False
    yield ("ln_f", "bias"), "ln_f.bias", False


def params_from_flax(params_np, config) -> "OrderedDict[str, torch.Tensor]":
    """Flax param tree (nested dict of arrays) -> the port's ``state_dict``."""
    state = OrderedDict()
    for path, name, transposed in _leaves(config):
        node = params_np
        for key in path:
            node = node[key]
        array = np.asarray(node)
        state[name] = torch.from_numpy(np.array(array.T if transposed else array, order="C"))
    return state


def params_to_flax(state_dict, config) -> dict:
    """The port's ``state_dict`` -> Flax param tree of numpy arrays."""
    tree: dict = {}
    for path, name, transposed in _leaves(config):
        array = state_dict[name].detach().cpu().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(array.T if transposed else array)
    return tree


def find_adam_state(opt_state):
    """The ``ScaleByAdamState`` node (a dict with ``count``, ``mu`` and
    ``nu``) of an optax state in state-dict form: ``optax.adam``'s own
    state, or the one inside a chain (clipping first, a schedule after)."""
    if isinstance(opt_state, dict):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state
        for key in sorted(opt_state):
            found = find_adam_state(opt_state[key])
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, config, names) -> dict:
    """optax Adam state (state-dict form) -> the port's ``Adam.state_dict()``;
    ``names`` is the model's parameter order (``named_parameters``)."""
    adam = find_adam_state(opt_state)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam moments (count, mu, nu)")
    mu = params_from_flax(adam["mu"], config)
    nu = params_from_flax(adam["nu"], config)
    return {"count": int(np.asarray(adam["count"])),
            "mu": [mu[name] for name in names], "nu": [nu[name] for name in names]}


def adam_state_to_optax(state, config, names) -> dict:
    """The port's ``Adam.state_dict()`` -> the ``ScaleByAdamState`` node
    (``count`` as int32, ``mu`` and ``nu`` as Flax trees of numpy arrays)."""
    return {"count": np.asarray(int(state["count"]), np.int32),
            "mu": params_to_flax(dict(zip(names, state["mu"])), config),
            "nu": params_to_flax(dict(zip(names, state["nu"])), config)}
