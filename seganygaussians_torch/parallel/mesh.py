"""Process groups, named meshes and the collectives of a parallel step.

Counterpart of ``seganygaussians_tpu/parallel/mesh.py``.  The JAX package
writes its parallel steps with ``shard_map`` over a named mesh and lets XLA
emit the collectives.  Here each rank runs the unbatched single-camera code,
and a step is a per-rank generator that yields its collectives as
:class:`Collective` requests and receives their results.  Two drivers run
such generators:

* :func:`run_distributed` issues each request as ``torch.distributed``
  collectives over the groups of a ``DeviceMesh`` (NCCL on the card, gloo on
  the CPU), one rank per process;
* :func:`run_in_turn` runs every rank of a :class:`Layout` in one process,
  in turn, and computes each collective from the ranks' values, so a test
  can check a step without processes and one card can run several ranks'
  work;
* :func:`run_alone` runs a step as the only rank of its mesh: the
  single-camera training steps are their parallel steps run so.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
from typing import Any, Generator, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

OPS = ("sum", "mean", "max", "gather")


class Collective(NamedTuple):
    """One collective of a step: ``op`` over the mesh ``axes`` of each of
    ``values``.  "gather" concatenates the ranks' values along dim 0 in
    their order on its single axis; the others reduce elementwise."""

    op: str
    axes: tuple[str, ...]
    values: tuple[torch.Tensor, ...]


def collective(op: str, axes: Union[str, Sequence[str]], *values: torch.Tensor) -> Collective:
    if op not in OPS:
        raise ValueError(f"unknown collective {op!r}; choose from {OPS}")
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if op == "gather" and len(axes) != 1:
        raise ValueError("gather runs over one mesh axis")
    return Collective(op, axes, values)


# A step: yields Collective requests, receives tuples of results, returns its result.
Step = Generator[Collective, tuple, Any]


@dataclasses.dataclass(frozen=True)
class Layout:
    """A mesh's named axes and their sizes; rank r sits at the row-major
    coordinate of r."""

    names: tuple[str, ...]
    shape: tuple[int, ...]

    @classmethod
    def of(cls, mesh: DeviceMesh) -> "Layout":
        return cls(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))

    def size(self, axis: str) -> int:
        return self.shape[self.names.index(axis)]

    def coords(self) -> list[dict[str, int]]:
        return [dict(zip(self.names, c)) for c in itertools.product(*map(range, self.shape))]


def initialize_distributed(
    device: Union[str, torch.device] = "cuda",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: Optional[float] = None,
) -> None:
    """``torch.distributed.init_process_group``: NCCL for a CUDA ``device``,
    gloo for the CPU.  Under ``torchrun`` call with the device alone (the
    environment names the rest); elsewhere pass ``init_method``
    (``tcp://localhost:<port>``), ``world_size`` and ``rank``.  On the card
    each rank takes the device of its local rank."""
    device = torch.device(device)
    given = dict(init_method=init_method, world_size=world_size, rank=rank,
                 timeout=None if timeout_s is None else datetime.timedelta(seconds=timeout_s))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            **{k: v for k, v in given.items() if v is not None})
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank()))
                              % torch.cuda.device_count())


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    axis_shape: Optional[Sequence[int]] = None,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """A ``DeviceMesh`` over the first ``n_devices`` ranks of the process
    group, with named axes.  1-D: every rank on ``axis_names[0]``; N-D:
    ``axis_shape`` sizes each axis (its product must be ``n_devices``), and
    without it the leading axis takes every rank.  The mesh's device type
    follows the process group's backend unless named."""
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"want {n_devices} ranks, the process group has {world}")
    if axis_shape is None:
        axis_shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    axis_shape = tuple(int(s) for s in axis_shape)
    if len(axis_shape) != len(axis_names):
        raise ValueError(f"axis_shape {axis_shape} does not name axes {tuple(axis_names)}")
    if math.prod(axis_shape) != n_devices:
        raise ValueError(f"axis_shape {axis_shape} does not tile {n_devices} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n_devices).reshape(axis_shape),
                      mesh_dim_names=tuple(axis_names))


def run_distributed(step: Step, mesh: DeviceMesh) -> Any:
    """Run this rank's ``step``, issuing each request as collectives over
    ``mesh``'s groups (a request over several axes reduces over each in
    turn).  Returns the step's result."""
    layout = Layout.of(mesh)
    request = next(step)
    while True:
        out = []
        for x in request.values:
            if request.op == "gather":
                group = mesh.get_group(request.axes[0])
                x = x.contiguous()
                parts = [torch.empty_like(x) for _ in range(layout.size(request.axes[0]))]
                dist.all_gather(parts, x, group=group)
                out.append(torch.cat(parts, dim=0))
                continue
            x = x.clone(memory_format=torch.contiguous_format)  # the collectives need it
            op = dist.ReduceOp.MAX if request.op == "max" else dist.ReduceOp.SUM
            for axis in request.axes:
                dist.all_reduce(x, op=op, group=mesh.get_group(axis))
            if request.op == "mean":
                x = x / math.prod(layout.size(a) for a in request.axes)
            out.append(x)
        try:
            request = step.send(tuple(out))
        except StopIteration as stop:
            return stop.value


def run_alone(step: Step) -> Any:
    """Run ``step`` as the only rank of its mesh, where every collective
    returns its own values.  Returns the step's result."""
    try:
        request = next(step)
        while True:
            request = step.send(request.values)
    except StopIteration as stop:
        return stop.value


def _reduce(op: str, values: list[torch.Tensor]) -> torch.Tensor:
    if op == "gather":
        return torch.cat(values, dim=0)
    stacked = torch.stack(values)
    if op == "max":
        return stacked.amax(dim=0)
    total = stacked.sum(dim=0)
    return total / len(values) if op == "mean" else total


def run_in_turn(steps: dict[int, Step], layout: Layout) -> dict[int, Any]:
    """Run one step per rank of ``layout`` (``steps[rank]``) in this process,
    in rank order up to each collective, which is computed from the values
    of the ranks that share every coordinate off its axes.  Returns each
    rank's result."""
    coords = layout.coords()
    if sorted(steps) != list(range(len(coords))):
        raise ValueError(f"need one step per rank of {layout}, got ranks {sorted(steps)}")
    requests = {r: next(s) for r, s in steps.items()}
    results: dict[int, Any] = {}
    while requests:
        if len(requests) != len(steps):
            raise RuntimeError("the ranks of a step issued different numbers of collectives")
        kinds = {(q.op, q.axes, len(q.values)) for q in requests.values()}
        if len(kinds) != 1:
            raise RuntimeError(f"the ranks issued different collectives: {kinds}")
        op, axes, n_values = kinds.pop()
        replies, by_group = {}, {}
        for r in requests:
            peers = tuple(p for p in requests if all(
                coords[p][a] == coords[r][a] for a in layout.names if a not in axes))
            if peers not in by_group:
                by_group[peers] = tuple(_reduce(op, [requests[p].values[i] for p in peers])
                                        for i in range(n_values))
            replies[r] = by_group[peers]
        for r in list(requests):
            try:
                requests[r] = steps[r].send(replies[r])
            except StopIteration as stop:
                results[r] = stop.value
                del requests[r]
    return results
