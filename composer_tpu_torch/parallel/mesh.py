"""A (data, model) device mesh over ``torch.distributed`` ranks: port of
``composer_tpu/parallel/mesh.py``.

JAX drives a mesh from one process, and XLA's SPMD partitioner inserts the
collectives that the logical annotations call for. PyTorch runs one process
a rank, so a ``Mesh`` here is one rank's view of the grid: the ``(data,
model)`` degrees, this rank's coordinates, its device, and three process
groups: every rank of the mesh, the ranks that share this rank's model
coordinate (its ``data_group``, over which gradients are averaged) and the
ranks that share its data coordinate (its ``model_group``, over which a
layer's partial products are summed). Ranks are laid out row-major, as
JAX's ``reshape(data, model)``: rank ``d * model + m`` has coordinates
``(d, m)``.

The collectives are explicit and only two: ``all_reduce`` and
``broadcast``, the ops that gloo also takes on CUDA tensors.
``copy_to_model`` (identity forward, ``all_reduce`` backward) and
``reduce_from_model`` (``all_reduce`` forward, identity backward) bracket
each tensor-parallel layer (``models/transformer.py``).

``LOGICAL_AXIS_RULES`` are the JAX package's; ``PARAM_LOGICAL_AXES`` gives
the logical axis of each dimension of each Transformer parameter, the JAX
module's ``nn.with_logical_partitioning`` annotations in torch's layouts
(a ``Linear`` weight is ``(out, in)``). ``shard_params`` cuts a full
single-device state dict to this rank's slices by those rules, and
``gather_params`` puts the slices back together. GSPMD may cut ``c_attn``'s
fused ``3E`` axis anywhere; here each of its q, k and v thirds is cut by
heads, so that a rank holds q, k and v of the same heads.
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

LOGICAL_AXIS_RULES = (
    ("batch", DATA_AXIS),
    ("heads", MODEL_AXIS),
    ("mlp", MODEL_AXIS),
    ("vocab", None),
    ("embed", None),
)

# The logical axis of each dimension of a decoder block's parameters, by
# name within the block. Everything else (wte, wpe, the LayerNorms, MusicRNN)
# is replicated.
PARAM_LOGICAL_AXES = {
    "attn.c_attn.weight": ("heads", "embed"),
    "attn.c_attn.bias": ("heads",),
    "attn.c_proj.weight": ("embed", "heads"),
    "attn.c_proj.bias": ("embed",),
    "attn.rel_embedding": ("heads", None, None),
    "mlp.c_fc.weight": ("mlp", "embed"),
    "mlp.c_fc.bias": ("mlp",),
    "mlp.c_proj.weight": ("embed", "mlp"),
    "mlp.c_proj.bias": ("embed",),
}
# Rows stacked as q, k and v: each third is cut by heads.
FUSED_QKV = ("attn.c_attn.weight", "attn.c_attn.bias")
# Process-group timeout when ``initialize_multihost`` is given none.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

# Host time spent in the mesh's collectives, read by chip_smoke.py phase 13
# for the collective's share of a step. Only counted while ``timed`` is true,
# and then every collective waits for the device before and after it.
COLLECTIVE_TIME = {"timed": False, "calls": 0, "seconds": 0.0}
_TIMEOUT: Optional[datetime.timedelta] = None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a ``(data, model)`` mesh (see the module
    docstring). A group is None where it holds this rank alone."""

    data: int
    model: int
    rank: int
    data_index: int
    model_index: int
    ranks: tuple
    device: torch.device
    group: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def leader(self) -> int:
        """The global rank at coordinates (0, 0): it writes checkpoints and
        takes requests."""
        return self.ranks[0]

    def global_rank(self, data_index: int, model_index: int) -> int:
        return self.ranks[data_index * self.model + model_index]


def tensor_parallel(mesh) -> bool:
    """Whether ``mesh`` cuts the model (a model degree above 1)."""
    return mesh is not None and mesh.model > 1


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: Optional[str] = None,
                         timeout: Optional[datetime.timedelta] = None):
    """Joins this process to a ``torch.distributed`` job; returns ``(rank,
    world)``.

    ``coordinator_address`` is ``host:port`` (TCP rendezvous at rank 0's
    store) or an ``init_method`` URL (``tcp://...``, ``file://...``); None
    reads ``MASTER_ADDR`` / ``MASTER_PORT`` from the environment. The
    backend defaults to NCCL when every rank of this host has a card of its
    own, gloo otherwise (the CPU, or several ranks sharing a card). Every
    group that ``create_mesh`` makes gets the same ``timeout``.
    """
    global _TIMEOUT
    if backend is None:
        own_card = (torch.cuda.is_available() and dist.is_nccl_available()
                    and num_processes is not None
                    and torch.cuda.device_count() >= num_processes)
        backend = "nccl" if own_card else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    _TIMEOUT = timeout or DEFAULT_TIMEOUT
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=_TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def _new_group(ranks):
    if len(ranks) == 1:
        return None
    return dist.new_group(list(ranks), timeout=_TIMEOUT or DEFAULT_TIMEOUT)


def create_mesh(data: Optional[int] = None, model: int = 1, ranks=None, device=None):
    """This rank's view of a ``(data, model)`` mesh over ``ranks`` (every
    rank of the job by default; a single process without
    ``torch.distributed`` is one rank).

    ``data=None`` puts every remaining rank on the data axis. As JAX
    truncates its device list, a mesh smaller than ``ranks`` takes the
    first ``data * model`` of them; every rank of the job must call this
    (the groups are made collectively), and a rank outside the mesh gets
    None. ``device`` defaults to the card ``rank % device_count``.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    ranks = tuple(range(world) if ranks is None else ranks)
    count = len(ranks)
    if data is None:
        if count % model != 0:
            raise ValueError(f"{count} ranks not divisible by model={model}")
        data = count // model
    if data < 1 or model < 1 or data * model > count:
        raise ValueError(f"a {data} x {model} mesh does not fit in {count} ranks")
    ranks = ranks[:data * model]
    # Every rank makes every group, in one order.
    group = _new_group(ranks)
    data_groups = [_new_group(ranks[m::model]) for m in range(model)]
    model_groups = [_new_group(ranks[d * model:(d + 1) * model]) for d in range(data)]
    if rank not in ranks:
        return None
    position = ranks.index(rank)
    data_index, model_index = divmod(position, model)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("create_mesh defaults to the card, and torch has no CUDA "
                               "here; pass device='cpu'")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(data=data, model=model, rank=rank, data_index=data_index,
                model_index=model_index, ranks=ranks, device=torch.device(device),
                group=group, data_group=data_groups[model_index],
                model_group=model_groups[data_index])


# ------------------------------------------------------------- collectives
def _timed(fn, tensor):
    if not COLLECTIVE_TIME["timed"]:
        fn()
        return
    if tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
    start = time.perf_counter()
    fn()
    if tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
    COLLECTIVE_TIME["calls"] += 1
    COLLECTIVE_TIME["seconds"] += time.perf_counter() - start


def all_reduce_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sums ``tensor`` over ``group`` in place (nothing for a group of one)."""
    if group is not None:
        _timed(lambda: dist.all_reduce(tensor, group=group), tensor)
    return tensor


def broadcast_(tensor: torch.Tensor, src: int, group) -> torch.Tensor:
    """``tensor`` from global rank ``src`` to every rank of ``group``, in place."""
    if group is not None:
        _timed(lambda: dist.broadcast(tensor, src=src, group=group), tensor)
    return tensor


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``x`` summed over ``group``, in float32 for narrower
    types (the partial products of a bf16 layer add without rounding in
    between), returned in ``x``'s dtype."""
    if group is None:
        return x
    total = x.float() if x.dtype != torch.float32 else x.clone()
    return all_reduce_(total, group).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad.contiguous(), ctx.group), None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a tensor-parallel layer: ``x`` as it is, and in the
    backward pass the sum of every model rank's gradient for it (each rank's
    slice of the layer sees only its part)."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The output of a tensor-parallel layer: the sum over the model group
    of each rank's partial product; the gradient passes through as it is."""
    return _ReduceFromModel.apply(x, mesh.model_group)


def sum_over_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the data group, differentiably (the backward sums
    the gradients too): statistics of the global batch, as MusicRNN's
    BatchNorm takes them."""
    if mesh.data_group is None:
        return x
    return _SumOverGroup.apply(x, mesh.data_group)


def mean_over_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the data group of a (detached) per-rank value."""
    if mesh.data_group is None:
        return x
    return _summed(x.detach(), mesh.data_group) / mesh.data


def local_rows(mesh: Mesh, batch):
    """This data coordinate's contiguous rows of a global batch (numpy or
    torch, rows first): the port's ``make_global_batch``, whose inverse
    ``gather_rows`` is."""
    rows = batch.shape[0]
    if rows % mesh.data:
        raise ValueError(f"batch {rows} not divisible by {DATA_AXIS}={mesh.data}")
    share = rows // mesh.data
    return batch[mesh.data_index * share:(mesh.data_index + 1) * share]


def gather_rows(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """Every data coordinate's ``rows``, stacked in coordinate order (the
    global batch), on every rank of the data group. Exact: each block is
    broadcast by its owner."""
    if mesh.data_group is None:
        return rows
    blocks = []
    for index in range(mesh.data):
        block = rows.contiguous() if index == mesh.data_index else torch.empty_like(rows)
        broadcast_(block, mesh.global_rank(index, mesh.model_index), mesh.data_group)
        blocks.append(block)
    return torch.cat(blocks)


# -------------------------------------------------------------- parameters
def _block_key(name: str) -> str:
    """``h_3.attn.c_attn.weight`` -> ``attn.c_attn.weight``."""
    head, _, rest = name.partition(".")
    return rest if head.startswith("h_") and head[2:].isdigit() else name


def model_dim(name: str) -> Optional[int]:
    """The dimension of parameter ``name`` that the model axis cuts, or None
    for a replicated one (by ``PARAM_LOGICAL_AXES`` and the rules)."""
    rules = dict(LOGICAL_AXIS_RULES)
    for dim, axis in enumerate(PARAM_LOGICAL_AXES.get(_block_key(name), ())):
        if axis is not None and rules.get(axis) == MODEL_AXIS:
            return dim
    return None


def is_sharded(name: str, mesh) -> bool:
    return tensor_parallel(mesh) and model_dim(name) is not None


def _slice(name: str, tensor: torch.Tensor, model: int, index: int) -> torch.Tensor:
    dim = model_dim(name)
    if _block_key(name) in FUSED_QKV:
        thirds = tensor.chunk(3, dim=dim)
        return torch.cat([t.chunk(model, dim=dim)[index] for t in thirds], dim=dim)
    return tensor.chunk(model, dim=dim)[index]


def shard_params(state_dict: dict, mesh) -> dict:
    """This rank's slices of a full single-device state dict (tensors other
    than sharded parameters pass through). The slices are copies."""
    if not tensor_parallel(mesh):
        return dict(state_dict)
    out = {}
    for name, tensor in state_dict.items():
        if model_dim(name) is None:
            out[name] = tensor
            continue
        if tensor.shape[model_dim(name)] % (3 * mesh.model if _block_key(name) in FUSED_QKV
                                            else mesh.model):
            raise ValueError(f"{name} of shape {tuple(tensor.shape)} not divisible by "
                             f"{MODEL_AXIS}={mesh.model}")
        out[name] = _slice(name, tensor, mesh.model, mesh.model_index).clone()
    return out


def gather_params(state_dict: dict, mesh) -> dict:
    """The inverse of ``shard_params``: the full tensors, on every rank of
    the model group. Every rank of the group must call it. Exact: each
    slice is broadcast by its owner."""
    if not tensor_parallel(mesh):
        return dict(state_dict)
    out = {}
    for name, tensor in state_dict.items():
        dim = model_dim(name)
        if dim is None:
            out[name] = tensor
            continue
        slices = []
        for index in range(mesh.model):
            part = (tensor.contiguous() if index == mesh.model_index
                    else torch.empty_like(tensor))
            broadcast_(part, mesh.global_rank(mesh.data_index, index), mesh.model_group)
            slices.append(part)
        if _block_key(name) in FUSED_QKV:
            thirds = [torch.cat([s.chunk(3, dim=dim)[third] for s in slices], dim=dim)
                      for third in range(3)]
            out[name] = torch.cat(thirds, dim=dim)
        else:
            out[name] = torch.cat(slices, dim=dim)
    return out
