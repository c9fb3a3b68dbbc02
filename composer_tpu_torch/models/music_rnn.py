"""MusicRNN, the stateful-LSTM baseline: port of ``composer_tpu/models/music_rnn.py``.

Embedding, then for each LSTM layer: LSTM, Dropout (where its rate is above
0), BatchNorm; then a Dense head over the vocabulary. ``forward`` returns
``(logits, new_state)``: the per-layer ``(c, h)`` carries are explicit, as in
the JAX module, so that the train loop decides when state persists across
batches.

Parameter names: ``embedding.weight``, ``lstm_{i}.weight_ih`` (4H, in),
``lstm_{i}.weight_hh`` (4H, H) and ``lstm_{i}.bias`` (4H), gates in Flax's
and torch's order i, f, g, o; ``batch_norm_{i}.weight`` / ``.bias`` with
the buffers ``running_mean`` / ``running_var``; ``output.weight`` /
``.bias``. ``models/convert.py`` (``rnn_params_from_flax``) maps them onto
the Flax tree.

What the JAX module does that torch's layers do another way:

* Flax's ``OptimizedLSTMCell`` has one bias a gate, on the hidden side; the
  input kernels have none. ``torch.lstm`` takes two biases: the port's one
  trainable bias goes into the first and zeros into the second, so the
  trainable set is Flax's (two trainable biases would each take a full
  Adam step, the sum learning at twice the rate).
* BatchNorm normalises over (batch, time) with the features last, momentum
  0.99 and epsilon 1e-3, and updates its running variance with the biased
  batch variance (``E[x^2] - E[x]^2`` in float32, clipped at 0); torch's
  ``BatchNorm1d`` would update it with the unbiased one. The port computes
  the statistics itself and writes the running buffers in place in a
  training forward (``deterministic=False``); ``deterministic=True``
  normalises with the running statistics.

Under data parallelism (``Trainer(mesh=)``, which sets each BatchNorm's
``mesh``) a training forward takes the statistics of the global batch: the
sum and the sum of squares are summed over the data group, as GSPMD
computes them for the JAX package's batch-sharded ``nn.BatchNorm``, so the
running statistics agree on every rank.

``config.dtype`` is the compute dtype: parameters (``param_dtype``) are cast
to it inside ``forward``, as Flax's ``dtype`` does, and the carries are
held in it. Dropout draws from the ``torch.Generator`` passed to
``forward``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
from torch import nn

from composer_tpu_torch.models.transformer import _dropout
from composer_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class MusicRNNConfig:
    vocab_size: int
    embed_dim: int = 256
    layer_sizes: Tuple[int, ...] = (512, 512, 512)
    dropout_rates: Tuple[float, ...] = (0.3, 0.3, 0.3)
    use_batch_normalization: bool = True
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32


def init_state(config: MusicRNNConfig, batch_size: int, device=None):
    """Zeroed LSTM carries: one ``(c, h)`` pair a layer, in the compute dtype."""
    return tuple(
        (torch.zeros((batch_size, size), dtype=config.dtype, device=device),
         torch.zeros((batch_size, size), dtype=config.dtype, device=device))
        for size in config.layer_sizes
    )


class LSTMLayer(nn.Module):
    """One LSTM layer over a whole ``[B, T, in]`` sequence (``torch.lstm``:
    cuDNN's LSTM on the card, bfloat16 included; torch's own on the CPU)."""

    def __init__(self, in_features: int, hidden: int, param_dtype):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_features, dtype=param_dtype))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(4 * hidden, dtype=param_dtype))

    def forward(self, x, carry, dtype):
        c, h = carry
        # The weights in compute dtype as views of one buffer laid out as
        # cuDNN's (input kernel, recurrent kernel, both biases), which cuDNN
        # then reads in place instead of copying them into a buffer of its
        # own at every call.
        flat = torch.cat([self.weight_ih.to(dtype).reshape(-1),
                          self.weight_hh.to(dtype).reshape(-1), self.bias.to(dtype),
                          torch.zeros(4 * self.hidden, dtype=dtype, device=x.device)])
        w_ih, w_hh, b_ih, b_hh = flat.split([self.weight_ih.numel(), self.weight_hh.numel(),
                                             4 * self.hidden, 4 * self.hidden])
        # ``train`` keeps what the backward needs (cuDNN refuses a backward
        # through an inference-mode call); there is no dropout within a layer.
        out, new_h, new_c = torch.lstm(
            x, (h.to(dtype)[None], c.to(dtype)[None]),
            [w_ih.view(self.weight_ih.shape), w_hh.view(self.weight_hh.shape), b_ih, b_hh],
            True, 1, 0.0, torch.is_grad_enabled(), False, True)
        return out, (new_c[0], new_h[0])


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over every axis but the last (see the module
    docstring)."""

    def __init__(self, features: int, param_dtype, momentum: float = 0.99,
                 epsilon: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype))
        self.register_buffer("running_mean", torch.zeros(features, dtype=torch.float32))
        self.register_buffer("running_var", torch.ones(features, dtype=torch.float32))
        # The data-parallel mesh whose global batch the statistics cover.
        self.mesh = None

    def forward(self, x, use_running_average: bool):
        xf = x.float()
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            if self.mesh is not None and self.mesh.data > 1:
                count = xf[..., 0].numel() * self.mesh.data
                sums = mesh_lib.sum_over_data(
                    torch.stack([xf.sum(axes), (xf * xf).sum(axes)]), self.mesh)
                mean, square = sums[0] / count, sums[1] / count
            else:
                mean, square = xf.mean(axes), (xf * xf).mean(axes)
            var = torch.clamp(square - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1 - self.momentum) * var)
        scale = torch.rsqrt(var + self.epsilon) * self.weight.float()
        return ((xf - mean) * scale + self.bias.float()).to(x.dtype)


class MusicRNN(nn.Module):
    """Returns ``(logits, new_state)``; ``state`` is the per-layer ``(c, h)``
    carry (zeros when None)."""

    def __init__(self, config: MusicRNNConfig, device=None):
        super().__init__()
        self.config = config
        self.embedding = nn.Embedding(config.vocab_size, config.embed_dim,
                                      dtype=config.param_dtype)
        width = config.embed_dim
        for index, size in enumerate(config.layer_sizes):
            self.add_module(f"lstm_{index}", LSTMLayer(width, size, config.param_dtype))
            if config.use_batch_normalization:
                self.add_module(f"batch_norm_{index}", BatchNorm(size, config.param_dtype))
            width = size
        self.output = nn.Linear(width, config.vocab_size, dtype=config.param_dtype)
        self.reset_parameters()
        if device is not None:
            self.to(device)

    @property
    def lstm_layers(self):
        return [getattr(self, f"lstm_{index}") for index in range(len(self.config.layer_sizes))]

    @property
    def batch_norms(self):
        if not self.config.use_batch_normalization:
            return [None] * len(self.config.layer_sizes)
        return [getattr(self, f"batch_norm_{index}")
                for index in range(len(self.config.layer_sizes))]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's initializers: Glorot uniform for each gate's input and
        recurrent kernel (the fan of that gate's own ``(in, H)`` matrix),
        zero biases, a normal embedding of variance ``1 / embed_dim``, a
        LeCun truncated normal head, unit BatchNorm scales, and running
        statistics 0 and 1. Values are drawn on the CPU and copied, so that
        a seed gives the same parameters on every device."""

        def draw(t, fill):
            t.copy_(fill(torch.empty(t.shape, dtype=t.dtype)))

        def glorot(rows):
            hidden, fan_in = rows.shape[0] // 4, rows.shape[1]
            bound = math.sqrt(6.0 / (fan_in + hidden))
            gates = [torch.empty((fan_in, hidden), dtype=rows.dtype).uniform_(
                -bound, bound, generator=generator).T for _ in range(4)]
            rows.copy_(torch.cat(gates))

        std = 1.0 / math.sqrt(self.config.embed_dim)
        draw(self.embedding.weight, lambda t: t.normal_(0.0, std, generator=generator))
        for lstm, norm in zip(self.lstm_layers, self.batch_norms):
            glorot(lstm.weight_ih)
            glorot(lstm.weight_hh)
            lstm.bias.zero_()
            if norm is not None:
                norm.weight.fill_(1.0)
                norm.bias.zero_()
                norm.running_mean.zero_()
                norm.running_var.fill_(1.0)
        # Flax rescales so the truncated distribution keeps stddev ``scaled``.
        scaled = 1.0 / math.sqrt(self.output.weight.shape[1]) / 0.87962566103423978
        draw(self.output.weight, lambda t: nn.init.trunc_normal_(
            t, 0.0, scaled, -2 * scaled, 2 * scaled, generator=generator))
        self.output.bias.zero_()

    def forward(self, tokens: torch.Tensor, state=None, deterministic: bool = True,
                generator: torch.Generator | None = None):
        config = self.config
        dtype = config.dtype
        if state is None:
            state = init_state(config, tokens.shape[0], device=tokens.device)
        x = self.embedding.weight.to(dtype)[tokens]
        new_state = []
        for index, (lstm, norm) in enumerate(zip(self.lstm_layers, self.batch_norms)):
            x, carry = lstm(x, state[index], dtype)
            new_state.append(carry)
            x = _dropout(x, config.dropout_rates[index], deterministic, generator)
            if norm is not None:
                x = norm(x, use_running_average=deterministic)
        logits = nn.functional.linear(x, self.output.weight.to(dtype), self.output.bias.to(dtype))
        return logits, tuple(new_state)
