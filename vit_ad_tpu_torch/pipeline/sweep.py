"""Sweep engine: categories x models x hyper-parameters (port of
`vit_ad_tpu/pipeline/sweep.py`; it replaces the reference's
trainings_loop.py:91-190, nested loops over a shared argv list, sequential,
with no crash recovery).

  * each run is a (category, data root, overrides) triple, `SweepRun`;
  * runs are idempotent and resumable: a finished run writes
    `<out>/<run>/done.json`, and a later sweep reuses that row only when its
    `_hp` stamp (the effective hyper-parameters, the dtype policy and the
    data location) matches; an error row carries no stamp, so it runs again;
  * a run that raises is isolated: its row holds `error` and its directory
    `traceback.txt`, and the sweep goes on;
  * every row lands in one `results.csv` with the reference's metric names,
    in the JAX package's column order;
  * `run_sweep_parallel` fans the categories out to worker processes, each
    pinned to its own card with `CUDA_VISIBLE_DEVICES`, with the same
    resume rule, collecting the rows from the `done.json` files.

The device is explicit: every trainer gets `device=` (the port's trainers
would otherwise train on the trunk's device, the CPU).

With `hp.mesh` (`--mesh DxM`, JAX :209-250) every run trains sharded over a
mesh of D·M ranks. `run_sweep` is then run by every rank of a cluster (the
`VITAD_*` variables), and the primary alone writes the rows, tracebacks and
`results.csv`; `run_sweep_parallel` gives each worker a disjoint group of
D·M cards, one process a rank, so `-j 4 --mesh 2x1` keeps four categories in
flight on eight cards.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from vit_ad_tpu_torch.config import HyperParams, check_device
from vit_ad_tpu_torch.data.loader import DataPipeline
from vit_ad_tpu_torch.parallel.multihost import is_primary, maybe_initialize_distributed

MVTEC_CATEGORIES = (
    "bottle", "cable", "capsule", "carpet", "grid", "hazelnut", "leather",
    "metal_nut", "pill", "screw", "tile", "toothbrush", "transistor",
    "wood", "zipper",
)
BTAD_CATEGORIES = ("01", "02", "03")


@dataclasses.dataclass
class SweepRun:
    category: str
    data_root: str           # e.g. data/mvtec_anomaly_detection
    train_pref: str = "train/good"
    test_pref: str = "test"
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        parts = [self.category] + [f"{k}={v}" for k, v in sorted(self.overrides.items())]
        return "_".join(str(p) for p in parts)


def _effective_hp(base_hp: HyperParams, run: SweepRun) -> HyperParams:
    hp = dataclasses.replace(base_hp, **run.overrides)
    hp.data_class = run.category
    return hp


def _hp_stamp(hp: HyperParams, run: Optional[SweepRun] = None) -> str:
    """Stamp of everything that decides a run's result: `to_log_dict` leaves
    out the dtype policy and the mesh, and the data location is the run's,
    so both are added; a resumed sweep with another policy or data root runs
    again instead of reusing stale rows."""
    d = hp.to_log_dict()
    d["_dtypes"] = str(hp.dtypes)
    if run is not None:
        d["_data_root"] = run.data_root
        d["_train_pref"] = run.train_pref
        d["_test_pref"] = run.test_pref
    return json.dumps(d, sort_keys=True, default=str)


def _execute_run(trainer: Callable, base_hp: HyperParams, run: SweepRun, out_dir: str,
                 resume: bool = True, device: str = "cuda") -> Dict[str, Any]:
    """One idempotent run: return its `done.json` row when it matches,
    else train on `device`, isolate a crash, and persist the row (the
    primary rank of a mesh alone writes)."""
    run_dir = os.path.join(out_dir, run.name)
    done_path = os.path.join(run_dir, "done.json")
    hp = _effective_hp(base_hp, run)
    hp_stamp = _hp_stamp(hp, run)
    if resume and os.path.exists(done_path):
        with open(done_path) as f:
            row = json.load(f)
        if row.get("_hp") == hp_stamp:
            return row
    primary = is_primary()
    if primary:
        os.makedirs(run_dir, exist_ok=True)
    base = os.path.join(run.data_root, run.category)
    try:
        data = DataPipeline(hp.batch_size, hp.img_size, base_path=base,
                            data_path=run.train_pref, amount_data=hp.amount_data)
        test = DataPipeline(hp.batch_size, hp.img_size, base_path=base,
                            data_path=run.test_pref, validation_mode=True)
        result = trainer(hp, data, test, device=device)
        row = {
            "Name": run.name,
            "dataclass": run.category,
            "model": hp.model_name,
            "epochs_ran": result.epochs_ran,
            "best_valid_loss": result.best_valid_loss,
            **result.metrics,
            "_hp": hp_stamp,
        }
    except Exception as e:  # crash isolation: the sweep goes on
        # no stamp: a resumed sweep retries the run, and the parallel
        # collection counts it as not done
        row = {
            "Name": run.name,
            "dataclass": run.category,
            "model": hp.model_name,
            "error": f"{type(e).__name__}: {e}",
        }
        if primary:
            with open(os.path.join(run_dir, "traceback.txt"), "w") as f:
                f.write(traceback.format_exc())
    if primary:
        with open(done_path, "w") as f:
            json.dump(row, f, default=float)
    return row


def run_sweep(trainer: Callable, base_hp: HyperParams, runs: Sequence[SweepRun],
              out_dir: str, resume: bool = True, device: str = "cuda") -> List[Dict[str, Any]]:
    """Run the sweep in this process on `device`, run after run; returns
    the rows and writes `<out_dir>/results.csv` after each (on a mesh, every
    rank runs it and the primary writes)."""
    check_device(device)
    if is_primary():
        os.makedirs(out_dir, exist_ok=True)
    rows: List[Dict[str, Any]] = []
    for run in runs:
        rows.append(_execute_run(trainer, base_hp, run, out_dir, resume, device))
        if is_primary():
            _write_csv(os.path.join(out_dir, "results.csv"), rows)
    return rows


TRAINERS = {
    "nf": "train_nf",
    "mdn": "train_mdn",
    "recon": "train_recon",
    "vae": "train_vae",
    "mdn_resnet": "train_mdn_resnet",
    "nf_resnet": "train_nf_resnet",
}


def resolve_trainer(arch: str) -> Callable:
    import vit_ad_tpu_torch.pipeline.train as T

    return getattr(T, TRAINERS[arch])


def _worker_main(arch: str, base_hp: HyperParams, runs: Sequence[SweepRun], out_dir: str,
                 resume: bool, worker_idx: int, device: str) -> None:
    """Body of one spawned worker (or of one rank of a worker's mesh): its
    slice of the runs on `device` (its card is the one
    `CUDA_VISIBLE_DEVICES` shows it)."""
    from vit_ad_tpu_torch.config import set_numerics_policy

    maybe_initialize_distributed()
    set_numerics_policy()
    trainer = resolve_trainer(arch)
    for run in runs:
        row = _execute_run(trainer, base_hp, run, out_dir, resume, device)
        if is_primary():
            print(f"[worker {worker_idx}] {run.name}: "
                  f"{row.get('image_auroc_score', row.get('error', '?'))}", flush=True)


def run_sweep_parallel(arch: str, base_hp: HyperParams, runs: Sequence[SweepRun],
                       out_dir: str, num_workers: int, resume: bool = True,
                       platform: str = "cuda") -> List[Dict[str, Any]]:
    """Fan independent category runs out to `num_workers` processes (the
    reference's sweep is sequential, trainings_loop.py:146-190). Worker i
    trains the runs i, i + num_workers, ... On `platform` "cuda" it sees
    card i alone (`launch.spawn_pinned`) and trains on `cuda`; on "cpu" it
    sees no card and trains on the CPU. Workers are spawned (CUDA does not
    survive a fork), so the hyper-parameters are pickled. More workers than
    cards are refused before anything is spawned. With `base_hp.mesh` (explicit sizes DxM) a worker
    is D·M processes, the ranks of its own cluster, on a disjoint group of
    D·M cards (no card on "cpu"). The rows come from the `done.json` files
    with the stamp check of `_execute_run`, so they are those of
    `run_sweep`; a worker that died raises after `results.csv` is
    written."""
    from vit_ad_tpu_torch.parallel.launch import spawn_pinned, visible_cards

    if platform not in ("cuda", "cpu"):
        raise ValueError(f"platform {platform!r}: 'cuda' or 'cpu'")
    ranks = 1
    if base_hp.mesh.requested:
        if base_hp.mesh.data < 1 or base_hp.mesh.model < 1:
            raise ValueError(
                "sweep workers need explicit mesh sizes (DxM); -1 ('all "
                "devices') is ambiguous when the sweep is also fanning out"
            )
        ranks = base_hp.mesh.data * base_hp.mesh.model
    check_device(platform)
    os.makedirs(out_dir, exist_ok=True)
    slices = [list(runs[i::num_workers]) for i in range(num_workers)]
    busy = sum(1 for s in slices if s)
    if platform == "cuda" and busy * ranks > torch.cuda.device_count():
        raise ValueError(f"{busy} sweep workers need {ranks} card{'s' if ranks > 1 else ''} "
                         f"each; torch.cuda.device_count() is {torch.cuda.device_count()}")

    # card indices as this process sees them, mapped through its own pinning
    cards = visible_cards()
    procs = []
    for i, slice_i in enumerate(slices):
        if slice_i:
            group = [""] * ranks if platform == "cpu" else cards[i * ranks:(i + 1) * ranks]
            procs += spawn_pinned(_worker_main, (arch, base_hp, slice_i, out_dir, resume, i,
                                                 platform), group, cluster=ranks > 1)

    failed = []
    for p in procs:
        p.join()
        if p.exitcode != 0:
            failed.append(p)

    rows: List[Dict[str, Any]] = []
    for run in runs:
        done_path = os.path.join(out_dir, run.name, "done.json")
        if os.path.exists(done_path):
            with open(done_path) as f:
                row = json.load(f)
            # a crashed worker must not surface a stale row of another sweep
            if row.get("_hp") == _hp_stamp(_effective_hp(base_hp, run), run):
                rows.append(row)
    _write_csv(os.path.join(out_dir, "results.csv"), rows)
    if failed:
        raise RuntimeError(f"{len(failed)} sweep workers died; completed {len(rows)}/"
                           f"{len(runs)} runs (run again to resume the rest)")
    return rows


def _write_csv(path: str, rows: List[Dict[str, Any]]) -> None:
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys and not k.startswith("_"):
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)
