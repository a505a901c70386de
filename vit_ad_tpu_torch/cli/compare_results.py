"""Compare a sweep `results.csv` against a reference csv_results_* baseline
(the port's copy of the JAX package's `tools/compare_results.py`: the same
parsing, gate, flags, output lines and exit codes).

The reference publishes its quality numbers as Weights & Biases run exports
(reference csv_results_{nf,gmm,recon}/*.csv): one row per wandb run, with
per-category evaluation rows named `Eval-...` and the category in the
`dataclass` column (BASELINE.md documents the metric columns). The port's
sweep engine (`pipeline/sweep.py`) writes one row per category with the same
metric names, so the two are directly joinable on category.

The BASELINE.md acceptance check, per-category image AUROC within 0.5 pts:

    python -m vit_ad_tpu_torch.cli.compare_results --ours sweep_out/results.csv \\
        --ref <reference repo>/csv_results_nf/nf_mvtec_lastblock.csv

Backbone-sweep baselines hold several eval rows per category (one per
encoder); disambiguate with `--encoder EsVit` (substring match on the
reference `architecture`/`encoder` columns).

Exit code 0 iff every compared category is within tolerance on every
requested metric; 1 when one is not; 2 when either side has no usable row.
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import Dict, List, Optional

DEFAULT_METRICS = ["image_auroc_score", "pixel_auroc_score"]


def _load_rows(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _category(row: Dict[str, str]) -> str:
    for key in ("dataclass", "data_class", "dataset"):
        v = (row.get(key) or "").strip()
        # wandb exports put the dataset NAME (mvtec/btad...) in `dataset`
        # for some sheets: only accept it when nothing better exists and it
        # does not look like a dataset name
        if v and v not in ("mvtec", "btad", "mvtec_anomaly_detection", "BTAD"):
            return v
    return ""


def _matches_encoder(row: Dict[str, str], needle: str) -> bool:
    hay = " ".join(
        (row.get(k) or "") for k in ("architecture", "encoder", "Tags", "Name")
    ).lower()
    return needle.lower() in hay


def load_reference(path: str, metrics: List[str],
                   encoder: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """category → {metric: value} from a wandb-export reference CSV.

    Prefers `Eval-*` rows (the reference's per-category re-evaluations, the
    numbers BASELINE.md aggregates); falls back to training rows for
    categories that have no eval row. With several candidate rows per
    category (gaussian-count or backbone sweeps), the LAST matching eval row
    wins unless `encoder` narrows the set, as BASELINE.md's per-category
    tables were read off.
    """
    out: Dict[str, Dict[str, float]] = {}
    fallback: Dict[str, Dict[str, float]] = {}
    for row in _load_rows(path):
        cat = _category(row)
        if not cat:
            continue
        if encoder and not _matches_encoder(row, encoder):
            continue
        vals = {}
        for m in metrics:
            raw = (row.get(m) or "").strip()
            if raw:
                try:
                    vals[m] = float(raw)
                except ValueError:
                    pass
        if not vals:
            continue
        name = (row.get("Name") or "").strip()
        if name.startswith("Eval-"):
            out[cat] = vals
        else:
            fallback[cat] = vals
    for cat, vals in fallback.items():
        out.setdefault(cat, vals)
    return out


def load_ours(path: str, metrics: List[str]) -> Dict[str, Dict[str, float]]:
    """category → {metric: value} from a sweep `results.csv`; rows with an
    error are left out."""
    out: Dict[str, Dict[str, float]] = {}
    for row in _load_rows(path):
        cat = _category(row)
        if not cat or row.get("error"):
            continue
        vals = {}
        for m in metrics:
            raw = (row.get(m) or "").strip()
            if raw:
                vals[m] = float(raw)
        if vals:
            out[cat] = vals
    return out


def compare(ours: Dict[str, Dict[str, float]], ref: Dict[str, Dict[str, float]],
            metrics: List[str], tolerance: float):
    """(lines, all_ok, summary dict). Only categories present on both sides
    are judged; one-sided categories are listed as coverage gaps. A category
    fails when ours falls short of the reference by more than `tolerance` on
    a metric; beating it never fails."""
    lines = []
    all_ok = True
    shared = sorted(set(ours) & set(ref))
    header = "| category | " + " | ".join(f"{m} ours / ref / Δ" for m in metrics) + " | ok |"
    lines.append(header)
    lines.append("|---" * (len(metrics) + 2) + "|")
    sums = {m: [0.0, 0.0, 0] for m in metrics}
    for cat in shared:
        cells, ok = [], True
        for m in metrics:
            o, r = ours[cat].get(m), ref[cat].get(m)
            if o is None or r is None:
                cells.append("—")
                continue
            d = o - r
            sums[m][0] += o
            sums[m][1] += r
            sums[m][2] += 1
            if d < -tolerance:
                ok = False
            cells.append(f"{o:.4f} / {r:.4f} / {d:+.4f}")
        all_ok &= ok
        lines.append(f"| {cat} | " + " | ".join(cells) + f" | {'yes' if ok else 'NO'} |")
    mean_cells = []
    for m in metrics:
        so, sr, n = sums[m]
        mean_cells.append(f"{so / n:.4f} / {sr / n:.4f} / {(so - sr) / n:+.4f}" if n else "—")
    lines.append("| **mean** | " + " | ".join(mean_cells) + f" | {'yes' if all_ok else 'NO'} |")
    missing_ours = sorted(set(ref) - set(ours))
    missing_ref = sorted(set(ours) - set(ref))
    if missing_ours:
        lines.append(f"\nnot in ours: {', '.join(missing_ours)}")
    if missing_ref:
        lines.append(f"not in reference: {', '.join(missing_ref)}")
    return lines, all_ok, {m: tuple(sums[m]) for m in metrics}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ours", required=True, help="sweep results.csv")
    ap.add_argument("--ref", required=True, help="reference csv_results_* CSV")
    ap.add_argument("--metrics", default=",".join(DEFAULT_METRICS),
                    help="comma-separated metric columns")
    ap.add_argument("--tolerance", type=float, default=0.005,
                    help="max allowed shortfall vs reference (0.005 = 0.5 pts;"
                         " beating the reference never fails)")
    ap.add_argument("--encoder", default=None,
                    help="filter reference rows by encoder/architecture "
                         "substring (backbone-sweep sheets)")
    args = ap.parse_args(argv)

    metrics = [m.strip() for m in args.metrics.split(",") if m.strip()]
    ref = load_reference(args.ref, metrics, args.encoder)
    ours = load_ours(args.ours, metrics)
    if not ref:
        print("no usable reference rows (wrong --encoder filter?)")
        return 2
    if not ours:
        print("no usable rows in --ours")
        return 2
    lines, all_ok, _ = compare(ours, ref, metrics, args.tolerance)
    print("\n".join(lines))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
