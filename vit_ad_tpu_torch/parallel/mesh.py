"""The (data, model) mesh of the port's ranks (port of
`vit_ad_tpu/parallel/mesh.py`).

A JAX process drives every local device of its mesh. Here each rank is a
process with one device, as is PyTorch's idiom: rank r sits at data index
r // M and model index r % M, the row-major layout of the JAX mesh
(`np.asarray(devices).reshape(data, model)`). The data axis shards the batch;
the model axis shards the MDN heads' mixture components and the transformer
trunks (`sharding.py`).

A mesh holds two sets of process groups:

  * host groups, on gloo: the mesh's ranks, and this rank's data and model
    axes. Host objects travel there (validation losses, metric payloads,
    the sweep's rows);
  * device groups for this rank's data and model axes, whose backend is
    chosen by rule (`device_backend`): NCCL when every rank has a card of its
    own, gloo when ranks share a card (NCCL refuses two ranks on one card)
    or run on the CPU. The ranks compare their cards' UUIDs over gloo when
    the mesh is made, and the primary prints the choice once.

Gloo's CUDA support covers all-reduce; its all-gather of a CUDA tensor goes
through host memory here, decided by the backend (`DeviceMesh.all_gather`),
and a broadcast (rare: `MeshContext.replicate`) always does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Devices = Union[None, str, torch.device, Sequence[Union[str, torch.device]]]
# meshes made in this process, by (data, model, device): making one creates
# process groups, a collective call that every rank makes in the same order
_MESHES: Dict[Tuple[int, int, str], "DeviceMesh"] = {}


def rank_layout(data: int, model: int) -> np.ndarray:
    """[data, model] array of ranks: rank r at (r // model, r % model)."""
    return np.arange(data * model).reshape(data, model)


def _resolve(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)  # the first card this rank sees
    return dev


def device_backend(device: torch.device, group: Any) -> Tuple[str, str]:
    """(backend, reason) of the device collectives: NCCL when every rank of
    `group` (a gloo group) has a card of its own, else gloo."""
    me = str(torch.cuda.get_device_properties(device).uuid) if device.type == "cuda" else "cpu"
    ids: List[Optional[str]] = [None] * dist.get_world_size(group)
    dist.all_gather_object(ids, me, group=group)
    if "cpu" in ids:
        return "gloo", "ranks on the CPU"
    if len(set(ids)) < len(ids):
        return "gloo", "ranks share a card, and NCCL takes one rank a card"
    return "nccl", "one card a rank"


@dataclasses.dataclass(eq=False)
class DeviceMesh:
    """This rank's place in a (data, model) mesh, its device and its groups."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str                      # of the device groups
    host: Any                         # gloo group of the mesh's ranks
    host_axes: Dict[str, Any]         # gloo groups of this rank's two axes
    device_axes: Dict[str, Any]       # device groups of this rank's two axes

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def index(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return self.rank // self.model if axis == "data" else self.rank % self.model

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: dist.ReduceOp.RedOpType = dist.ReduceOp.SUM) -> torch.Tensor:
        """A reduced copy of `t` over `axis` (t itself on an axis of one)."""
        if self.shape[axis] == 1:
            return t
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, op=op, group=self._group(out, axis))
        return out

    def all_gather(self, t: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every rank's `t` along `axis`, in axis order; a CUDA tensor on gloo
        crosses through host memory."""
        if self.shape[axis] == 1:
            return [t]
        src = t.detach().contiguous()
        via_host = src.is_cuda and self.backend == "gloo"
        if via_host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(parts, src, group=self._group(src, axis))
        return [p.to(t.device) for p in parts] if via_host else parts

    def broadcast(self, t: torch.Tensor, src_rank: int = 0) -> torch.Tensor:
        """`t` of mesh rank `src_rank` on every rank, in place, through host
        memory."""
        host = t.detach().cpu()
        dist.broadcast(host, src=src_rank, group=self.host)
        with torch.no_grad():
            t.copy_(host)
        return t

    def _group(self, t: torch.Tensor, axis: str) -> Any:
        return self.device_axes[axis] if t.is_cuda else self.host_axes[axis]


def create_mesh(data: int = -1, model: int = 1, devices: Devices = None) -> DeviceMesh:
    """The (data, model) mesh over the ranks of the initialized process group
    (`multihost.maybe_initialize_distributed`, or
    `torch.distributed.init_process_group` with a gloo default group).
    data=-1 takes every remaining rank. `devices`: the ranks' devices in rank
    order (rank r takes devices[r]), or one device every rank takes, its own
    card for "cuda"; default each rank's first visible card. Made once per
    (data, model, device) in a process; every rank makes its meshes in the
    same order."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if devices is None:
        devices = "cuda"
    if not isinstance(devices, (str, torch.device)):
        devices = list(devices)
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} ranks: give one a rank")
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the ranks of a process group: start them with "
                           "--mesh or the VITAD_COORDINATOR / VITAD_NUM_PROCESSES / "
                           "VITAD_PROCESS_ID variables")
    rank = dist.get_rank()
    device = _resolve(devices if isinstance(devices, (str, torch.device)) else devices[rank])
    key = (data, model, str(device))
    if key in _MESHES:
        return _MESHES[key]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    layout = rank_layout(data, model)
    host = dist.new_group(list(range(n)), backend="gloo")
    backend, reason = device_backend(device, host)

    def axes(kind: str) -> Dict[str, Any]:
        # every rank creates every group, in one order
        by_model = [dist.new_group(layout[:, m].tolist(), backend=kind) for m in range(model)]
        by_data = [dist.new_group(layout[d].tolist(), backend=kind) for d in range(data)]
        return {"data": by_model[rank % model], "model": by_data[rank // model]}

    host_axes = axes("gloo")
    device_axes = host_axes if backend == "gloo" else axes(backend)
    mesh = DeviceMesh(data, model, rank, device, backend, host, host_axes, device_axes)
    if rank == 0:
        print(f"mesh {data}x{model} ({n} ranks, rank r at data r // {model}, model r % "
              f"{model}) on {device.type}: device collectives over {backend} ({reason})",
              flush=True)
    _MESHES[key] = mesh
    return mesh
