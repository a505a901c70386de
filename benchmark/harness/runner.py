"""One run of one cell: set-up, the measured window, the readings of a
traced run, the check against the reference, and the result line."""

from __future__ import annotations

import gc
import importlib
import json
import subprocess
import sys
import time
from types import ModuleType
from typing import Callable, Dict, List, Tuple

import torch

from harness import check, spec
from harness.reading import Reading, percentile
from harness.score import ScoreCell
from harness.spec import Cell
from harness.trace import Trace
from harness.train import TrainCell

FORBIDDEN = ("jax", "jaxlib", "flax", "vit_ad_tpu")
# the traffic file's "kind" → the loop that drives it
KINDS = {"score": ScoreCell, "train": TrainCell}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def launch_counters() -> Dict[str, Tuple[ModuleType, str]]:
    """The port's launch counters that kernel files name (`COUNTERS =
    {label: "module.attribute"}` in `kernels/<id>.py`), label → (module,
    attribute), sorted by label: proof that the cell's kernels ran, and a
    new kernel's file puts its counter on the launch line."""
    out = {}
    for kernel in spec.kernel_names():
        for label, where in getattr(spec.kernel_count(kernel), "COUNTERS", {}).items():
            module, attr = where.rsplit(".", 1)
            out[label] = (importlib.import_module(module), attr)
    return dict(sorted(out.items()))


def launch_counts(counters: Dict[str, Tuple[ModuleType, str]]) -> Dict[str, int]:
    return {label: getattr(module, attr) for label, (module, attr) in counters.items()}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_process: float, log: Callable[[str], None] = print) -> dict:
    """Run `cell` once; return the result object (the last line's)."""
    from vit_ad_tpu_torch.config import set_numerics_policy

    set_numerics_policy()
    on_card = device.type == "cuda"
    t_imports = time.perf_counter() - t_process
    runner = KINDS[cell.kind](cell, seed, device)
    runner.warm_up()
    trace_s = float(cell.traffic["trace_seconds"]) if trace else 0.0
    counters = launch_counters()
    before = launch_counts(counters)
    setup_s = time.perf_counter() - t_process
    units, window_s, traced = runner.window(seconds, min(trace_s, seconds))
    after = launch_counts(counters)
    per_unit = {k: (after[k] - before[k]) / units for k in after}
    log("launches a " + ("batch" if cell.kind == "score" else "step") + ": "
        + ", ".join(f"{k} {v:g}" for k, v in per_unit.items()))
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        prof, traced_units = traced
        t = Trace(prof)
        del prof
        reading = Reading(cell=cell, trace=t, units=traced_units,
                          images=traced_units * runner.batch,
                          enqueue_s=runner.enqueue,
                          latency_s=getattr(runner, "latency", [])[:len(runner.enqueue)])
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"]).read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        breakdown = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
        log(f"traced: {traced_units} units in {t.window_s:.6f} s, device busy {t.busy_s:.6f} s, "
            f"unattributed device s {t.unattributed_s:.6f}, ranges "
            + ", ".join(f"{k} {v:.6f} s" for k, v in sorted(t.range_s.items())))
        log(f"trace events by activity: {dict(t.activity_counts)}")
    else:
        e2e = {m["name"]: m for m in cell.end_to_end}
        images = units * runner.batch
        values = {"setup_s": setup_s}
        if cell.kind == "score":
            values["score_img_per_s"] = images / window_s
            values["score_p95_ms"] = 1e3 * percentile(runner.latency, 95)
            log(f"scored {units} batches of {runner.batch} in {window_s:.6f} s; latency ms "
                f"median {1e3 * percentile(runner.latency, 50):.4f} p95 "
                f"{values['score_p95_ms']:.4f} max {1e3 * max(runner.latency):.4f} "
                f"(n={len(runner.latency)})")
        else:
            values["train_img_per_s"] = images / window_s
            log(f"stepped {units} steps of {runner.batch} rows in {window_s:.6f} s")
        for name, v in values.items():
            if name in e2e:
                metrics[name] = {"value": float(v), "unit": e2e[name]["unit"]}
    log(f"setup_s {setup_s:.6f}: start and imports {t_imports:.3f} s, "
        + ", ".join(f"{k} {v:.3f} s" for k, v in runner.phases.items())
        + f"; memory_peak_bytes {peak}")
    # the check: the program's state freed, then the reference
    runner.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    values = runner.reference()
    correct, checks = check.verdict(values, cell.limits)
    others = {k: v for k, v in values.items() if k not in checks}
    if others:
        log(f"read, not compared: {json.dumps(others)}")
    log(f"reference took {time.perf_counter() - t_ref:.3f} s")
    if getattr(runner, "last_details", None):
        log(f"check details: {json.dumps(runner.last_details)}")
    # last, after everything the run loads (metric readers, kernel counts,
    # the reference): no module of JAX or the JAX package may be among them
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {found}")
    result = {"correct": correct, "attempted": units, "failed": 0, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def report(result: dict) -> None:
    """The check's numbers as the last lines on stderr, then the result as
    the last line on stdout."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
