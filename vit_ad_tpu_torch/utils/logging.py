"""Metric logging (port of `vit_ad_tpu/utils/logging.py`).

The reference logs to Weights & Biases (project "masterthesis", reference
src/pipeline/LearnerRecon.py:84-128). Here, as in the JAX package, the sink
is local: `metrics.jsonl` (one record per `log` call) and `metrics.csv` (the
scalar fields; its header grows to the union of the keys, and the file is
rewritten when it does) in the run directory, beside `config.json`. wandb is
imported only when `enable_wandb` is set; where it cannot be imported or
started, the logger says so in one line and logs locally.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(self, log_dir: str, run_name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None, enable_wandb: bool = False,
                 project: str = "masterthesis") -> None:
        self.run_name = run_name or f"run_{time.strftime('%Y%m%d-%H%M%S')}"
        self.dir = os.path.join(log_dir, self.run_name)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._csv_path = os.path.join(self.dir, "metrics.csv")
        self._csv_keys: list = []
        self._csv_rows: list = []
        self._wandb = None
        if config:
            self.write_config(config)
        if enable_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=self.run_name,
                                         config=config or {})
            except Exception as e:  # noqa: BLE001 — absent or offline: log locally
                print(f"MetricLogger: wandb unavailable ({type(e).__name__}: {e}); "
                      f"logging to {self.dir} only", flush=True)

    def write_config(self, config: Dict[str, Any]) -> None:
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)

    def log(self, metrics: Dict[str, Any]) -> None:
        record = {"_time": time.time(), **metrics}
        self._jsonl.write(json.dumps(record, default=float) + "\n")
        self._jsonl.flush()
        scalar = {k: v for k, v in record.items() if isinstance(v, (int, float, str))}
        self._csv_rows.append(scalar)
        new_keys = [k for k in scalar if k not in self._csv_keys]
        if new_keys:
            # the header grows (the eval keys arrive after the epoch rows):
            # rewrite the whole file with the union of the keys
            self._csv_keys.extend(new_keys)
            with open(self._csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_keys)
                w.writeheader()
                w.writerows(self._csv_rows)
        else:
            with open(self._csv_path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._csv_keys,
                               extrasaction="ignore").writerow(scalar)
        if self._wandb is not None:
            self._wandb.log(metrics)

    def log_figure(self, name: str, path: str) -> None:
        """Register a saved figure with the wandb run, when there is one (a
        local run already has the file)."""
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Image(path)})

    def log_artifact(self, path: str) -> None:
        """Attach a file (a checkpoint) to the wandb run, when there is one."""
        if self._wandb is not None:
            import wandb

            wandb.save(path, base_path=os.path.dirname(path))

    def finish(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
