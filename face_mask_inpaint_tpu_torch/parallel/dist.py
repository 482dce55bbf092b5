"""Data parallel over ``torch.distributed``: the port's counterpart of
face_mask_inpaint_tpu/parallel/mesh.py.

The JAX trainers shard each global batch over a 1-D mesh and let GSPMD
insert the reductions, so a sharded step is the single-device step on the
global batch. Here each rank is one process holding a replica of the
models and a contiguous slice of every global batch, and a train step that
is handed a ``Group`` computes the one-process step on the global batch:

- the gradients are averaged over the ranks after they are taken and before
  the optimizer steps (``all_reduce_mean``), one flat buffer per dtype. The
  steps take their gradients with ``torch.autograd.grad``, which the
  ``DistributedDataParallel`` wrapper's hooks never see, so no step uses it;
- the reductions over the batch that come before a nonlinearity read the
  group that the step makes active (``data_parallel``/``active``):
  BatchNorm's moments (nn/layers.py), the whole-batch Dice's sums
  (losses/dice.py) and the contextual loss's feature mean (losses/vgg.py)
  are summed over the ranks with ``all_reduce_sum``, whose backward sums
  each rank's upstream gradient; the averaging of the gradients then
  cancels the factor of the rank count;
- noise drawn inside a module (``sample_z``, StyleGAN2's ``NoiseInjection``)
  is drawn at the global batch's shape from the generator every rank seeded
  alike, and each rank keeps its slice (``randn_batch``).

Eval steps never make a group active, so they compute on what they are
given. Only all-reduce and broadcast are used: gloo cannot all-gather CUDA
tensors, and it is the backend where ranks share one card.

A trainer CLI reads torchrun's environment (``init_from_env``); with one
rank there is no process group and every step runs as it does without this
module.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import logging
import os
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as tdist

__all__ = ["Group", "DistEnv", "init", "init_from_env", "shutdown", "round_batch",
           "local_batch_size", "rank_slice", "active", "data_parallel", "all_reduce_sum",
           "all_reduce_mean", "mean_over_ranks", "broadcast_", "broadcast_module",
           "broadcast_values", "barrier", "agree", "randn_batch"]

TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class Group:
    """The ranks a train step's global batch is split over (the default
    process group): this process's ``rank``, their number ``size`` and the
    device of the collectives' buffers."""

    rank: int
    size: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class DistEnv:
    """What a trainer needs to know of the ranks: its device, the group its
    train steps use and the backend of the process group (None with one
    rank)."""

    device: torch.device
    group: Optional[Group] = None
    backend: Optional[str] = None

    @property
    def rank(self) -> int:
        return 0 if self.group is None else self.group.rank

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else self.group.size

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _device_and_backend(device_name: str, local_rank: int, local_world_size: int,
                        world_size: int) -> tuple[torch.device, Optional[str]]:
    """``cuda:LOCAL_RANK`` over NCCL when each rank has a card of its own;
    ``cuda:0`` over gloo when the ranks share one; gloo on the CPU."""
    device = torch.device(device_name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    if world_size == 1:
        return device, None
    if device.type != "cuda":
        return device, "gloo"
    if local_world_size <= torch.cuda.device_count():
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", 0), "gloo"


def init(rank: int, world_size: int, device_name: str, init_method: str = "env://",
         local_rank: Optional[int] = None, local_world_size: Optional[int] = None) -> DistEnv:
    """Join ``world_size`` ranks at ``init_method`` (a ``file://`` or
    ``tcp://`` address, or torchrun's ``env://``) and return this rank's
    environment: NCCL when each rank has a card of its own, else gloo. One
    rank joins nothing: its group is None."""
    local_rank = rank if local_rank is None else local_rank
    local_world_size = world_size if local_world_size is None else local_world_size
    device, backend = _device_and_backend(device_name, local_rank, local_world_size,
                                          world_size)
    if backend is None:
        return DistEnv(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tdist.init_process_group(backend, init_method=init_method, rank=rank,
                             world_size=world_size, timeout=TIMEOUT)
    if rank == 0:
        logging.info("data parallel: %d ranks, backend %s, rank 0 on %s%s", world_size,
                     backend, device, " (the ranks share one card)"
                     if device.type == "cuda" and backend == "gloo" else "")
    return DistEnv(device, Group(rank, world_size, device), backend)


def init_from_env(device_name: str) -> DistEnv:
    """The rank of a process started by ``torch.distributed.run``, from its
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``; a
    process started without them is the one rank of a world of one."""
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", "1"))
    return init(int(env.get("RANK", "0")), world_size, device_name, "env://",
                int(env.get("LOCAL_RANK", "0")), int(env.get("LOCAL_WORLD_SIZE", world_size)))


def shutdown() -> None:
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


def round_batch(batch_size: int, world_size: int) -> int:
    """The JAX CLIs' global batch: ``max(b, W) // W * W``."""
    return max(batch_size, world_size) // world_size * world_size


def local_batch_size(global_batch: int, world_size: int) -> int:
    if global_batch % world_size:
        raise ValueError(f"global batch {global_batch} not divisible by {world_size} ranks")
    return global_batch // world_size


def rank_slice(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """This rank's contiguous slice of a global batch (dim 0)."""
    if group is None:
        return x
    n = local_batch_size(x.shape[0], group.size)
    return x[group.rank * n:(group.rank + 1) * n]


# -- the group of the running train step ------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("data_parallel_group",
                                                         default=None)


def active() -> Optional[Group]:
    """The group of the train step that is running, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def data_parallel(group: Optional[Group]):
    """Make ``group`` the one the batch-coupled reductions and the noise
    read, for the duration of a train step (in this thread or task)."""
    token = _ACTIVE.set(group)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


# -- collectives --------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """y = sum over the ranks of x; its backward sums the ranks' upstream
    gradients, the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.contiguous().clone()
        tdist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        g = grad.contiguous().clone()
        tdist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``x`` over the ranks."""
    return _AllReduceSum.apply(x)


def _flat_groups(tensors: Sequence[torch.Tensor]) -> dict:
    by_kind: dict = {}
    for i, t in enumerate(tensors):
        by_kind.setdefault((t.dtype, t.device), []).append(i)
    return by_kind


def all_reduce_mean(tensors: Sequence[torch.Tensor], group: Group) -> list[torch.Tensor]:
    """The mean over the ranks of each tensor (gradients), through one flat
    buffer per dtype and device; returns views of those buffers."""
    out: list = [None] * len(tensors)
    for idx in _flat_groups(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        tdist.all_reduce(flat)
        flat.div_(group.size)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out


def mean_over_ranks(values: dict, group: Group) -> dict:
    """Scalar metrics averaged over the ranks in one collective (f32, f64
    for f64 values); the ranks' equal slices make it the global mean of a
    per-sample mean."""
    keys = list(values)
    if not keys:
        return {}
    dtype = torch.promote_types(torch.float32, values[keys[0]].dtype)
    flat = torch.stack([values[k].detach().reshape(()).to(group.device, dtype)
                        for k in keys])
    tdist.all_reduce(flat)
    flat.div_(group.size)
    return {k: flat[i].to(values[k].device) for i, k in enumerate(keys)}


def broadcast_(tensors: Iterable[torch.Tensor], group: Group) -> None:
    """Overwrite each tensor with rank 0's, one flat buffer per dtype and
    device."""
    tensors = list(tensors)
    for idx in _flat_groups(tensors).values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        tdist.broadcast(flat, 0)
        offset = 0
        with torch.no_grad():
            for i in idx:
                n = tensors[i].numel()
                tensors[i].copy_(flat[offset:offset + n].view(tensors[i].shape))
                offset += n


def broadcast_module(module: torch.nn.Module, group: Optional[Group]) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if group is not None:
        broadcast_([*module.parameters(), *module.buffers()], group)


def broadcast_values(values: Optional[Sequence[float]], n: int,
                     group: Optional[Group]) -> list[float]:
    """Rank 0's ``n`` floats on every rank (the other ranks pass None), in
    float64."""
    if group is None:
        return [float(v) for v in values]
    buf = (torch.tensor([float(v) for v in values], dtype=torch.float64) if group.rank == 0
           else torch.zeros(n, dtype=torch.float64)).to(group.device)
    tdist.broadcast(buf, 0)
    return buf.tolist()


def barrier(group: Optional[Group]) -> None:
    """Wait for every rank, through an all-reduce."""
    if group is not None:
        tdist.all_reduce(torch.zeros(1, device=group.device))


def agree(values: Sequence[float], what: str, group: Optional[Group]) -> None:
    """Raise on every rank unless every rank holds rank 0's ``values``."""
    if group is None:
        return
    mine = [float(v) for v in values]
    differs = torch.tensor([float(broadcast_values(mine, len(mine), group) != mine)],
                           device=group.device)
    tdist.all_reduce(differs)
    if differs.item():
        raise RuntimeError(f"{int(differs.item())} of {group.size} ranks disagree with rank "
                           f"0 on {what}: this rank has {mine}")


def randn_batch(shape: Sequence[int], group: Optional[Group],
                generator: Optional[torch.Generator] = None, **kw) -> torch.Tensor:
    """``torch.randn(shape)``; under a group, this rank's slice of the draw
    at the global batch's shape, so every image gets the noise the
    one-process step gives it."""
    if group is None:
        return torch.randn(tuple(shape), generator=generator, **kw)
    n = shape[0]
    full = torch.randn((n * group.size, *shape[1:]), generator=generator, **kw)
    return full[group.rank * n:(group.rank + 1) * n]
