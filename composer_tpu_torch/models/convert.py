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

MusicRNN (``rnn_params_from_flax``, ``rnn_params_to_flax``): Flax's
``OptimizedLSTMCell_{i}`` holds per-gate kernels ``ii/if/ig/io`` (in, H)
and ``hi/hf/hg/ho`` (H, H) with a bias on the hidden side only; the port's
``lstm_{i}`` packs them transposed in gate order i, f, g, o into
``weight_ih`` (4H, in) and ``weight_hh`` (4H, H), and the hidden biases into
``bias`` (4H). BatchNorm ``scale`` is ``weight``; the ``batch_stats``
collection's ``mean`` / ``var`` are the buffers ``running_mean`` /
``running_var``. The Adam moments of either model go through its own
mapping (``adam_state_from_optax`` and ``adam_state_to_optax`` take the
model's config).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from composer_tpu_torch.models.music_rnn import MusicRNNConfig

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


_GATES = ("i", "f", "g", "o")


def rnn_params_from_flax(params_np, batch_stats_np, config) -> "OrderedDict[str, torch.Tensor]":
    """MusicRNN ``params`` (and ``batch_stats``, or None for a tree of
    parameters alone, such as an Adam moment) -> the port's ``state_dict``."""

    def tensor(array):
        return torch.from_numpy(np.array(np.asarray(array), order="C"))

    def packed(cell, side):
        return tensor(np.concatenate([np.asarray(cell[f"{side}{g}"]["kernel"]).T
                                      for g in _GATES]))

    state = OrderedDict()
    state["embedding.weight"] = tensor(params_np["embedding"]["embedding"])
    for index in range(len(config.layer_sizes)):
        cell = params_np[f"OptimizedLSTMCell_{index}"]
        state[f"lstm_{index}.weight_ih"] = packed(cell, "i")
        state[f"lstm_{index}.weight_hh"] = packed(cell, "h")
        state[f"lstm_{index}.bias"] = tensor(np.concatenate(
            [np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES]))
        if config.use_batch_normalization:
            norm = f"batch_norm_{index}"
            state[f"{norm}.weight"] = tensor(params_np[norm]["scale"])
            state[f"{norm}.bias"] = tensor(params_np[norm]["bias"])
            if batch_stats_np is not None:
                state[f"{norm}.running_mean"] = tensor(batch_stats_np[norm]["mean"])
                state[f"{norm}.running_var"] = tensor(batch_stats_np[norm]["var"])
    state["output.weight"] = tensor(np.asarray(params_np["output"]["kernel"]).T)
    state["output.bias"] = tensor(params_np["output"]["bias"])
    return state


def rnn_params_to_flax(state_dict, config) -> tuple:
    """The port's MusicRNN ``state_dict`` -> ``(params, batch_stats)``, Flax
    trees of numpy arrays (``batch_stats`` is empty where the state_dict
    holds no running statistics)."""

    def array(name):
        return np.ascontiguousarray(state_dict[name].detach().cpu().numpy())

    params = {"embedding": {"embedding": array("embedding.weight")}}
    batch_stats = {}
    for index, hidden in enumerate(config.layer_sizes):
        weight_ih, weight_hh = array(f"lstm_{index}.weight_ih"), array(f"lstm_{index}.weight_hh")
        bias = array(f"lstm_{index}.bias")
        cell = {}
        for gate_index, gate in enumerate(_GATES):
            rows = slice(gate_index * hidden, (gate_index + 1) * hidden)
            cell[f"i{gate}"] = {"kernel": np.ascontiguousarray(weight_ih[rows].T)}
            cell[f"h{gate}"] = {"kernel": np.ascontiguousarray(weight_hh[rows].T),
                                "bias": np.ascontiguousarray(bias[rows])}
        params[f"OptimizedLSTMCell_{index}"] = cell
        if config.use_batch_normalization:
            norm = f"batch_norm_{index}"
            params[norm] = {"scale": array(f"{norm}.weight"), "bias": array(f"{norm}.bias")}
            if f"{norm}.running_mean" in state_dict:
                batch_stats[norm] = {"mean": array(f"{norm}.running_mean"),
                                     "var": array(f"{norm}.running_var")}
    params["output"] = {"kernel": np.ascontiguousarray(array("output.weight").T),
                        "bias": array("output.bias")}
    return params, batch_stats


def _tree_from_flax(tree, config):
    """A Flax tree shaped like the params -> named tensors, for either model."""
    if isinstance(config, MusicRNNConfig):
        return rnn_params_from_flax(tree, None, config)
    return params_from_flax(tree, config)


def _tree_to_flax(named, config) -> dict:
    if isinstance(config, MusicRNNConfig):
        return rnn_params_to_flax(named, config)[0]
    return params_to_flax(named, config)


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
    mu = _tree_from_flax(adam["mu"], config)
    nu = _tree_from_flax(adam["nu"], config)
    return {"count": int(np.asarray(adam["count"])),
            "mu": [mu[name] for name in names], "nu": [nu[name] for name in names]}


def adam_state_to_optax(state, config, names) -> dict:
    """The port's ``Adam.state_dict()`` -> the ``ScaleByAdamState`` node
    (``count`` as int32, ``mu`` and ``nu`` as Flax trees of numpy arrays)."""
    return {"count": np.asarray(int(state["count"]), np.int32),
            "mu": _tree_to_flax(dict(zip(names, state["mu"])), config),
            "nu": _tree_to_flax(dict(zip(names, state["nu"])), config)}
