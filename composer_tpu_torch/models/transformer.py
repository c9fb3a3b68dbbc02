"""Music Transformer: a decoder-only LM with optional relative attention.

Port of ``composer_tpu/models/transformer.py``. GPT-2 style: tied token
embedding, learned positional embedding, N pre-LN decoder blocks (attention
plus a 4x tanh-GELU MLP), final LayerNorm, tied output head. Parameter names
follow the Flax tree (``wte``, ``wpe``, ``h_{i}.ln_1``, ``h_{i}.attn.c_attn``,
``h_{i}.attn.rel_embedding`` ...), so ``models/convert.py`` maps one onto the
other name by name.

Quirks carried over from the reference:

* the residual adds the attention output to the **ln_1 output**, not to the
  block input;
* GELU is the tanh approximation;
* logits are tied to ``wte``;
* positions are ``cache_index + arange(seq)``, clamped to ``window - 1``
  (the JAX gather clamps out-of-range indices the same way).

``config.dtype`` is the compute dtype: parameters (``param_dtype``) are cast
to it inside ``forward``, as Flax's ``dtype`` does.

Training (``deterministic=False``) adds the reference's dropout: on the
embedding sum, after each attention and MLP output projection (residual
rate), and on the attention weights. Its random numbers come from the
``torch.Generator`` passed to ``forward``; the flash path draws one int32
seed per layer call from it and drops inside the kernel.

``remat`` (Flax's ``nn.remat`` around each block) recomputes each block's
activations in the backward pass (``torch.utils.checkpoint``) instead of
keeping them; the recompute draws the forward's dropout bits
(``_checkpointed_block``), so loss and gradients do not change.

Tensor parallelism: a config whose ``flash_mesh`` (the JAX field's name;
a ``parallel/mesh.py`` mesh) has a model degree above 1 builds this rank's
slice of each block, ``H / model`` heads and ``4E / model`` MLP units
(``local_heads``; an indivisible count raises ``ValueError`` here, where
the JAX package falls back to its band path). ``copy_to_model`` goes before
``c_attn`` and ``c_fc``, ``reduce_from_model`` after the partial ``c_proj``
products and before their (replicated) bias; the embeddings, the LayerNorms
and the logits are replicated (``vocab`` and ``embed`` map to no mesh
axis). ``reset_parameters`` draws the full single-device tensors and keeps
this rank's slices (``shard_params``), so a seed gives the single-device
weights.

The KV cache is a dict ``{"index": int, "layers": [{"k", "v"}]}`` of
``[B, H, S, D]`` buffers (this rank's heads under tensor parallelism).
Unlike the functional JAX module, ``forward`` writes the new keys and values
into those buffers in place (no copy of the cache per token) and returns the
dict with the advanced index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from composer_tpu_torch.ops import attention as attention_ops
from composer_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    embed_dim: int = 256
    window_size: int = 1024
    num_layers: int = 8
    num_heads: int = 16
    use_relative_attention: bool = False
    attention_dropout_rate: float = 0.1
    residual_dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-5
    scale_attention: bool = True
    initializer_mean: float = 0.0
    initializer_stddev: float = 0.02
    use_layer_norm: bool = True
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    # Routes square causal attention through ops/flash_attention.py (the
    # Hopper kernels on CUDA); see ops/attention.py for the rule.
    use_pallas_attention: bool = False
    # Accepted for config compatibility and ignored: the chunked and band
    # branches compute the same function (ROADMAP.md).
    attention_chunk_size: int = 0
    band_block_size: int = 128
    # Recompute each block's activations in the backward pass (training only).
    remat: bool = False
    flash_mesh: Any = None

    @property
    def head_dim(self) -> int:
        if self.embed_dim % self.num_heads:
            raise ValueError(
                f"embed_dim {self.embed_dim} is not divisible by num_heads "
                f"{self.num_heads}"
            )
        return self.embed_dim // self.num_heads


def _model_share(count: int, name: str, mesh) -> int:
    model = mesh.model if mesh_lib.tensor_parallel(mesh) else 1
    if count % model:
        raise ValueError(f"{name} {count} not divisible by {mesh_lib.MODEL_AXIS}={model}")
    return count // model


def local_heads(config: TransformerConfig) -> int:
    """The heads of this rank: ``num_heads`` over the mesh's model degree
    (all of them without tensor parallelism)."""
    return _model_share(config.num_heads, "heads", config.flash_mesh)


def init_cache(config: TransformerConfig, batch_size: int, max_length: int,
               dtype=None, device=None):
    """Preallocated KV cache: per layer ``[B, H, S, D]`` k/v buffers (``H``
    this rank's heads) plus the fill index."""
    dtype = dtype or config.dtype
    shape = (batch_size, local_heads(config), max_length, config.head_dim)
    return {
        "index": 0,
        "layers": [
            {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(config.num_layers)
        ],
    }


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    # Statistics in f32 (Flax promotes the same way), output in compute dtype.
    return F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(),
        norm.eps,
    ).to(dtype)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


def _dropout(x: torch.Tensor, rate: float, deterministic: bool, generator) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability ``1 - rate``, scale kept
    values by ``1 / (1 - rate)``."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class SelfAttention(nn.Module):
    """Fused-QKV causal self-attention with optional relative bias (this
    rank's heads under tensor parallelism)."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.mesh = config.flash_mesh if mesh_lib.tensor_parallel(config.flash_mesh) else None
        self.heads = local_heads(config)
        e, width = config.embed_dim, self.heads * config.head_dim
        self.c_attn = nn.Linear(e, 3 * width, dtype=config.param_dtype)
        self.c_proj = nn.Linear(width, e, dtype=config.param_dtype)
        if config.use_relative_attention:
            self.rel_embedding = nn.Parameter(torch.empty(
                self.heads, config.window_size, config.head_dim,
                dtype=config.param_dtype,
            ))
        else:
            self.rel_embedding = None

    def forward(self, x, layer_cache=None, cache_index=None, deterministic=True,
                generator=None):
        config = self.config
        dtype = config.dtype
        batch, seq, _ = x.shape
        if self.mesh is not None:
            x = mesh_lib.copy_to_model(x, self.mesh)
        q, k, v = _dense(self.c_attn, x, dtype).chunk(3, dim=-1)

        def heads(t):
            return t.reshape(batch, seq, self.heads, config.head_dim).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        rel = self.rel_embedding.to(dtype) if self.rel_embedding is not None else None

        q_position = None
        if layer_cache is not None:
            layer_cache["k"][:, :, cache_index:cache_index + seq] = k
            layer_cache["v"][:, :, cache_index:cache_index + seq] = v
            if seq == 1:
                # Incremental decode: attend over the whole cache; the causal
                # mask follows from the absolute query position.
                k, v = layer_cache["k"], layer_cache["v"]
                q_position = cache_index
            # Prefill (from index 0) is the square self-attention over the
            # written prefix: the same math as the uncached forward.

        out = attention_ops.multihead_attention(
            q, k, v, rel_embedding=rel, q_position=q_position,
            scale=config.scale_attention, dropout_generator=generator,
            dropout_rate=0.0 if deterministic else config.attention_dropout_rate,
            use_pallas=config.use_pallas_attention, flash_mesh=config.flash_mesh,
        )
        out = out.transpose(1, 2).reshape(batch, seq, self.heads * config.head_dim)
        out = _projection(self.c_proj, out, dtype, self.mesh)
        return _dropout(out, config.residual_dropout_rate, deterministic, generator)


def _projection(layer: nn.Linear, x: torch.Tensor, dtype, mesh) -> torch.Tensor:
    """An output projection: under tensor parallelism this rank's partial
    product, summed over the model group, then the replicated bias."""
    if mesh is None:
        return _dense(layer, x, dtype)
    partial = F.linear(x, layer.weight.to(dtype))
    return mesh_lib.reduce_from_model(partial, mesh) + layer.bias.to(dtype)


class Mlp(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.mesh = config.flash_mesh if mesh_lib.tensor_parallel(config.flash_mesh) else None
        e = config.embed_dim
        hidden = _model_share(4 * e, "mlp", config.flash_mesh)
        self.c_fc = nn.Linear(e, hidden, dtype=config.param_dtype)
        self.c_proj = nn.Linear(hidden, e, dtype=config.param_dtype)

    def forward(self, x, deterministic=True, generator=None):
        dtype = self.config.dtype
        if self.mesh is not None:
            x = mesh_lib.copy_to_model(x, self.mesh)
        hidden = F.gelu(_dense(self.c_fc, x, dtype), approximate="tanh")
        out = _projection(self.c_proj, hidden, dtype, self.mesh)
        return _dropout(out, self.config.residual_dropout_rate, deterministic, generator)


class DecoderBlock(nn.Module):
    """Pre-LN decoder block with the reference's residual quirk."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        eps = config.layer_norm_epsilon
        if config.use_layer_norm:
            self.ln_1 = nn.LayerNorm(config.embed_dim, eps=eps, dtype=config.param_dtype)
            self.ln_2 = nn.LayerNorm(config.embed_dim, eps=eps, dtype=config.param_dtype)
        self.attn = SelfAttention(config)
        self.mlp = Mlp(config)

    def forward(self, x, layer_cache=None, cache_index=None, deterministic=True,
                generator=None):
        dtype = self.config.dtype
        h = _layer_norm(self.ln_1, x, dtype) if self.config.use_layer_norm else x
        # The attention output is added to the *normalized* input.
        x = h + self.attn(h, layer_cache, cache_index, deterministic, generator)
        m = _layer_norm(self.ln_2, x, dtype) if self.config.use_layer_norm else x
        return x + self.mlp(m, deterministic, generator)


def _checkpointed_block(block: DecoderBlock, x, deterministic: bool, generator):
    """``block`` under ``torch.utils.checkpoint`` (the non-reentrant form).

    The backward pass runs the block a second time, and that recompute must
    draw the forward's dropout bits. ``checkpoint`` restores only the
    default CPU and CUDA generators, never an explicit ``generator``, so the
    generator's state at the block's start is kept, set again for the
    recompute, and afterwards put back where the whole forward left it."""
    if generator is None or deterministic:
        return torch.utils.checkpoint.checkpoint(
            block, x, None, None, deterministic, generator, use_reentrant=False)
    start = generator.get_state()
    forward_done = []

    def run(h):
        if not forward_done:
            forward_done.append(True)
            return block(h, None, None, deterministic, generator)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return block(h, None, None, deterministic, generator)
        finally:
            generator.set_state(after)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


class Transformer(nn.Module):
    """The decoder-only LM. ``forward`` returns ``(logits, new_cache)``."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.wte = nn.Parameter(torch.empty(
            config.vocab_size, config.embed_dim, dtype=config.param_dtype))
        self.wpe = nn.Parameter(torch.empty(
            config.window_size, config.embed_dim, dtype=config.param_dtype))
        for layer in range(config.num_layers):
            self.add_module(f"h_{layer + 1}", DecoderBlock(config))
        self.ln_f = nn.LayerNorm(config.embed_dim, eps=config.layer_norm_epsilon,
                                 dtype=config.param_dtype)
        self.reset_parameters()
        if device is not None:
            self.to(device)

    @property
    def blocks(self):
        return [getattr(self, f"h_{layer + 1}") for layer in range(self.config.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's initializers: truncated normal (+-2 std) matmul and
        embedding weights, zero biases, unit LayerNorm scales and a Glorot
        uniform relative table. Under tensor parallelism: the full
        single-device tensors, of which this rank keeps its slices."""
        if mesh_lib.tensor_parallel(self.config.flash_mesh):
            full = Transformer(dataclasses.replace(self.config, flash_mesh=None))
            full.reset_parameters(generator)
            self.load_state_dict(mesh_lib.shard_params(full.state_dict(), self.config.flash_mesh))
            return
        std = self.config.initializer_stddev
        # Flax rescales so the truncated distribution keeps stddev ``std``.
        scaled = std / 0.87962566103423978

        # Values are drawn on the CPU and copied, so that a seed gives the
        # same parameters on every device.
        def normal(t):
            t.copy_(nn.init.trunc_normal_(torch.empty(t.shape, dtype=t.dtype), 0.0, scaled,
                                          -2 * scaled, 2 * scaled, generator=generator))

        normal(self.wte)
        normal(self.wpe)
        for block in self.blocks:
            for layer in (block.attn.c_attn, block.attn.c_proj, block.mlp.c_fc, block.mlp.c_proj):
                normal(layer.weight)
                nn.init.zeros_(layer.bias)
            rel = block.attn.rel_embedding
            if rel is not None:
                fan_in = rel.shape[1] * rel.shape[2]
                fan_out = rel.shape[0] * rel.shape[2]
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                rel.copy_(nn.init.uniform_(torch.empty(rel.shape, dtype=rel.dtype), -bound,
                                           bound, generator=generator))

    def forward(self, tokens: torch.Tensor, cache=None, deterministic: bool = True,
                generator: torch.Generator | None = None):
        config = self.config
        dtype = config.dtype
        _, seq = tokens.shape
        cache_index = cache["index"] if cache is not None else 0
        positions = torch.arange(seq, device=tokens.device) + cache_index
        positions = positions.clamp(max=config.window_size - 1)
        h = self.wte.to(dtype)[tokens] + self.wpe.to(dtype)[positions][None]
        h = _dropout(h, config.residual_dropout_rate, deterministic, generator)

        remat = config.remat and cache is None and torch.is_grad_enabled()
        for layer, block in enumerate(self.blocks):
            if remat:
                h = _checkpointed_block(block, h, deterministic, generator)
                continue
            layer_cache = cache["layers"][layer] if cache is not None else None
            h = block(h, layer_cache, cache_index if cache is not None else None,
                      deterministic, generator)

        h = _layer_norm(self.ln_f, h, dtype)
        logits = torch.einsum("bse,ve->bsv", h, self.wte.to(dtype))
        new_cache = None
        if cache is not None:
            new_cache = {"index": cache_index + seq, "layers": cache["layers"]}
        return logits, new_cache
