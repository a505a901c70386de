"""Local launcher of a mesh's ranks: one process per rank, each pinned to its
card (the second way ranks start; the first is an explicit cluster, the
third the API, `multihost.py`).

`--mesh DxM` in a CLI run without a cluster in the environment spawns D·M
local processes that run the same CLI as ranks of a cluster meeting on a
free local port: rank r sees card r alone (`CUDA_VISIBLE_DEVICES`), or no
card under `--device cpu`, where the ranks are the counterpart of the JAX
package's virtual CPU mesh. Fewer visible cards than ranks is refused before
anything is spawned.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import socket
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

from vit_ad_tpu_torch.config import MeshConfig


def free_port() -> int:
    """A TCP port on the loopback interface that no one listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def visible_cards() -> List[str]:
    """The card indices this process sees, as `CUDA_VISIBLE_DEVICES` names
    them to child processes."""
    shown = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    return shown.split(",") if shown else [str(c) for c in range(torch.cuda.device_count())]


def mesh_size(mesh: MeshConfig, on_card: bool) -> int:
    """Ranks of `mesh`; 'auto' (-1) takes every visible card. Raises
    SystemExit when the cards are too few, before anything is spawned."""
    if not on_card:
        if mesh.data < 1 or mesh.model < 1:
            raise SystemExit("--mesh auto takes every visible card; on the CPU give its "
                             "sizes (DxM)")
        return mesh.data * mesh.model
    cards = torch.cuda.device_count()
    data = cards // mesh.model if mesh.data == -1 else mesh.data
    need = data * mesh.model
    if need < 1 or need > cards:
        raise SystemExit(f"--mesh {mesh.data}x{mesh.model} needs {max(need, mesh.model)} cards, "
                         f"one a rank; torch.cuda.device_count() is {cards}")
    return need


def spawn_pinned(target: Callable, args: Sequence, cards: Sequence[str],
                 cluster: bool) -> List[mp.Process]:
    """Start one spawned process a card of `cards`, each running
    `target(*args)` and seeing its card alone (`CUDA_VISIBLE_DEVICES`; ""
    hides every card). With `cluster` process r is rank r of a new cluster
    (the `VITAD_*` variables, a free local port). A process reads the
    environment when it starts: it is set for each spawn and restored
    after."""
    coordinator = f"127.0.0.1:{free_port()}" if cluster else ""
    ctx = mp.get_context("spawn")
    procs = []
    saved = dict(os.environ)
    try:
        for r, card in enumerate(cards):
            if cluster:
                os.environ.update(cluster_env(coordinator, len(cards), r))
            os.environ["CUDA_VISIBLE_DEVICES"] = card
            p = ctx.Process(target=target, args=tuple(args))
            p.start()
            procs.append(p)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return procs


def join(procs: Sequence[mp.Process]) -> int:
    """Wait for every process; 0 when all exited 0, else the first other
    exit code."""
    codes = []
    for p in procs:
        p.join()
        codes.append(p.exitcode)
    return next((c for c in codes if c), 0)


def _run_cli(module: str, argv: List[str]) -> None:
    sys.exit(importlib.import_module(module).main(argv))


def launch_cli(module: str, argv: List[str], mesh: MeshConfig, device: str) -> Optional[int]:
    """Run CLI `module` as the local ranks of `mesh`: its exit code, or None
    when this process runs the CLI itself (no mesh requested, or already a
    rank of a cluster)."""
    from vit_ad_tpu_torch.parallel.multihost import in_cluster

    if not mesh.requested or in_cluster():
        return None
    on_card = torch.device(device).type == "cuda"
    world = mesh_size(mesh, on_card)
    return join(spawn_pinned(_run_cli, (module, list(argv)),
                             visible_cards()[:world] if on_card else [""] * world, cluster=True))


def cluster_env(coordinator: str, world: int, rank: int) -> Dict[str, str]:
    """The environment that makes a process rank `rank` of a cluster."""
    return {"VITAD_COORDINATOR": coordinator, "VITAD_NUM_PROCESSES": str(world),
            "VITAD_PROCESS_ID": str(rank)}
