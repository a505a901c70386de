"""Clusters of ranks (port of `vit_ad_tpu/parallel/multihost.py`).

The JAX package connects its processes with `jax.distributed.initialize()`
and then sees one global device list. Here every rank is a process; an
explicit cluster is set up from the JAX package's environment contract:

  * `VITAD_COORDINATOR=host:port` + `VITAD_NUM_PROCESSES` +
    `VITAD_PROCESS_ID`: this process is rank `VITAD_PROCESS_ID` of the
    cluster; the gloo default group meets at `tcp://host:port`. It takes the
    card `cuda:0` of what `CUDA_VISIBLE_DEVICES` shows it, or the CPU under
    `--device cpu`.
  * `VITAD_MULTIHOST=1`, TPU-pod auto-detection, has no counterpart: it is
    refused, naming the three variables.

Beside it, what the framework adds on top of the mesh: host snapshots of
sharded heads (`host_snapshot`, the full reference layout), gathers of
batch-sharded payloads (`fetch_global`) and primary-rank gating of file
writes (`is_primary`). Every rank runs the same program over the same data:
the data layer is deterministic, so every rank materializes the same
batches and keeps its own rows.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

CLUSTER_VARIABLES = ("VITAD_COORDINATOR", "VITAD_NUM_PROCESSES", "VITAD_PROCESS_ID")


def maybe_initialize_distributed() -> bool:
    """Join the cluster the environment names; True when this process is (or
    already was) a rank of one. Runs before the device is chosen."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("VITAD_COORDINATOR")
    if coord:
        n = os.environ.get("VITAD_NUM_PROCESSES")
        pid = os.environ.get("VITAD_PROCESS_ID")
        if n is None or pid is None:
            raise SystemExit(
                "VITAD_COORDINATOR is set but VITAD_NUM_PROCESSES / "
                "VITAD_PROCESS_ID are not — all three are required for an "
                "explicit cluster"
            )
        dist.init_process_group("gloo", init_method=f"tcp://{coord}", world_size=int(n),
                                rank=int(pid))
        return True
    if os.environ.get("VITAD_MULTIHOST") == "1":
        raise SystemExit("VITAD_MULTIHOST=1 (TPU-pod auto-detection) has no counterpart in "
                         "the port: name the cluster with " + ", ".join(CLUSTER_VARIABLES))
    return False


def in_cluster() -> bool:
    """True when this process is a rank of a cluster, or the environment
    names one it will join."""
    return dist.is_initialized() or bool(os.environ.get("VITAD_COORDINATOR"))


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the rank that writes files (checkpoints, run directories,
    scores); always True in a single process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the cluster (nothing in a single process)."""
    if is_multihost():
        dist.barrier()


def host_snapshot(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state dict on the CPU, every K-sharded MDN head and every
    sharded trunk inside it gathered back to the full reference layout (a
    collective: every rank of the mesh calls it). Without a shard it is the
    plain state dict, copied to the CPU."""
    from vit_ad_tpu_torch.parallel.sharding import gather_mdn_state, gather_trunk_state

    out = {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}
    for prefix, sub in module.named_modules():
        lead = f"{prefix}." if prefix else ""
        if getattr(sub, "mesh", None) is not None and hasattr(sub, "components"):
            out.update({lead + k: v for k, v in gather_mdn_state(sub).items()})
        elif getattr(sub, "model_shard", None) is not None and hasattr(sub.model_shard, "rules"):
            out.update({lead + k: v for k, v in gather_trunk_state(sub).items()})
    return out


def fetch_global(x: torch.Tensor, mesh: Optional[Any] = None) -> np.ndarray:
    """The host copy of a payload whose rows are sharded over the mesh's data
    axis: the data ranks' rows in order, on every rank. Without a mesh, the
    host copy of `x`."""
    if mesh is None:
        return x.detach().cpu().numpy()
    return torch.cat(mesh.gather_rows(x.detach().cpu())).numpy()
