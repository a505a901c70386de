"""One-command quality-parity harness of the port: the full §6 matrix against
the reference's csv_results_* tables (the port's counterpart of the JAX
package's `tools/parity_matrix.py`: the same matrix, flags, rehearsal and
outputs, on `--device`).

The reference's published results are W&B CSV exports under
`<reference repo>/csv_results_{nf,gmm,recon}/` (BASELINE.md). This tool runs
the matching training and evaluation matrix through the port's sweep engine
(`pipeline/sweep.py`: resumable, crash-isolated), writes one `results.csv`
per entry in the reference's metric schema, and gates each entry with
`cli/compare_results.py`'s 0.5-pt per-category image-AUROC check.

The day real MVTec/BTAD data are on the machine, the matrix is ONE command
(the sweep engine builds each trunk from `hp.seed`, as the JAX tool's does;
neither package wires pretrained trunk weights into the sweep yet):

    python -m vit_ad_tpu_torch.cli.parity_matrix --data-root /data \\
        --ref-dir <reference repo> --out parity_out

Data layout expected under --data-root (the reference's own layout,
reference GeneralDataLoader paths):

    <root>/mvtec_anomaly_detection/<category>/{train/good,test/...}
    <root>/BTech_Dataset_transformed/<category>/...   (01/02/03)

Rehearsal mode (synthetic stand-ins: proves the plumbing end to end so the
real run needs no debugging):

    python -m vit_ad_tpu_torch.cli.parity_matrix --rehearse --out /tmp/parity_rehearsal

generates tiny synthetic datasets (the first two categories of each
dataset; as in the JAX tool, the other categories end as error rows, which
the gate leaves out), shrinks the configs, swaps the reference CSVs for
stand-ins written from its own rows, and must exit 0 with every entry
compared. The rehearsal runs on `--device` like the real matrix: `cuda` (the
default) exits without a card unless `--device cpu` is given.

Writes `<out>/<entry>/results.csv`, `<out>/parity_summary.json` and, last on
stdout, `{"parity_matrix_ok": ..., "entries": n}`; exit 0 only when every
entry passes.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

MVTEC_DIR = "mvtec_anomaly_detection"
BTAD_DIR = "BTech_Dataset_transformed"

# The §6 matrix: one entry per reference headline CSV (BASELINE.md), entry
# for entry the JAX tool's. `overrides` apply on top of HyperParams'
# reference-default values.
MATRIX = [
    dict(name="nf_mvtec_lastblock", arch="nf", dataset="mvtec",
         overrides=dict(model_name="enc_deit", architecture="nf"),
         ref_csv="csv_results_nf/nf_mvtec_lastblock.csv"),
    dict(name="nf_btad", arch="nf", dataset="btad",
         overrides=dict(model_name="enc_deit", architecture="nf"),
         ref_csv="csv_results_nf/nf_btad.csv"),
    dict(name="gmm_mvtec_100_gaussians", arch="mdn", dataset="mvtec",
         overrides=dict(model_name="enc_deit", architecture="mdn", num_gaussians=100),
         ref_csv="csv_results_gmm/gmm_mvtec_100_gaussians.csv"),
    dict(name="gmm_btad_100_gaussians", arch="mdn", dataset="btad",
         overrides=dict(model_name="enc_deit", architecture="mdn", num_gaussians=100),
         ref_csv="csv_results_gmm/gmm_btad_100_gaussians.csv"),
    dict(name="recon_mvtec_resnetdecod", arch="recon", dataset="mvtec",
         overrides=dict(model_name="ae_res_net", architecture="reconstruction"),
         ref_csv="csv_results_recon/recon_mvtec_resnetdecod.csv"),
    dict(name="recon_mvtec_smalldecod", arch="recon", dataset="mvtec",
         overrides=dict(model_name="ae_res_net_small", architecture="reconstruction"),
         ref_csv="csv_results_recon/recon_mvtec_smalldecod.csv"),
]

# the rehearsal's tiny configuration (flags given on the command line win)
REHEARSAL_HP = {"epochs": 2, "patience": 2, "batch_size": 4, "img_size": 32,
                "num_gaussians": 2, "learning_rate": 3e-3}
# full DeiT/ResNet at 224 is the real matrix; the rehearsal swaps in small
# models but keeps every arch/decoder pairing distinct
REHEARSAL_MODELS = {"enc_deit": "enc_cnn", "ae_res_net": "ae_cnn", "ae_res_net_small": "ae_cnn"}
HP_FLAGS = ("epochs", "patience", "batch_size", "img_size", "num_gaussians")


def rehearsal_matrix(matrix):
    """`matrix` with the rehearsal's model swap applied."""
    return [dict(e, overrides={
        **e["overrides"],
        "model_name": REHEARSAL_MODELS.get(e["overrides"]["model_name"],
                                           e["overrides"]["model_name"]),
    }) for e in matrix]


def _dataset_cats_and_root(dataset: str, data_root: str):
    from vit_ad_tpu_torch.pipeline.sweep import BTAD_CATEGORIES, MVTEC_CATEGORIES

    if dataset == "mvtec":
        return MVTEC_CATEGORIES, os.path.join(data_root, MVTEC_DIR)
    return BTAD_CATEGORIES, os.path.join(data_root, BTAD_DIR)


def run_entry(entry, data_root, out_dir, hp_overrides, categories=None, device="cuda"):
    """Train and evaluate one matrix entry over its dataset's categories (or
    `categories` of them) through `run_sweep` on `device`; returns the path
    of its `results.csv` and its rows."""
    from vit_ad_tpu_torch.config import HyperParams
    from vit_ad_tpu_torch.pipeline.sweep import SweepRun, resolve_trainer, run_sweep

    cats, root = _dataset_cats_and_root(entry["dataset"], data_root)
    if categories:
        cats = [c for c in cats if c in categories]
    hp = HyperParams(**{**entry["overrides"], **hp_overrides})
    runs = [SweepRun(category=c, data_root=root) for c in cats]
    trainer = resolve_trainer(entry["arch"])
    entry_out = os.path.join(out_dir, entry["name"])
    rows = run_sweep(trainer, hp, runs, entry_out, device=device)
    return os.path.join(entry_out, "results.csv"), rows


def compare_entry(ours_csv, ref_csv, tolerance, metrics):
    """(ok, table lines) of `cli/compare_results.compare` on the two CSVs."""
    from vit_ad_tpu_torch.cli.compare_results import compare, load_ours, load_reference

    ref = load_reference(ref_csv, metrics)
    ours = load_ours(ours_csv, metrics)
    lines, ok, _ = compare(ours, ref, metrics, tolerance)
    return ok, lines


def _write_stand_in_reference(rows, path, metrics):
    """Rehearsal: a reference-schema CSV built from our own rows (the real
    run diffs against the reference's CSVs instead)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["Name", "dataclass"] + metrics)
        w.writeheader()
        for r in rows:
            if "error" in r:
                continue
            w.writerow({"Name": f"Eval-{r['dataclass']}", "dataclass": r["dataclass"],
                        **{m: r.get(m, "") for m in metrics}})


def _make_rehearsal_data(data_root, matrix, img=32):
    """The first two categories of each dataset `matrix` names, synthetic,
    in the reference's folder layout (an existing category is kept)."""
    from vit_ad_tpu_torch.data.synthetic import make_mvtec_category
    from vit_ad_tpu_torch.pipeline.sweep import BTAD_CATEGORIES, MVTEC_CATEGORIES

    need = set()
    for e in matrix:
        if e["dataset"] == "mvtec":
            need.add((MVTEC_DIR, MVTEC_CATEGORIES[:2]))
        else:
            need.add((BTAD_DIR, BTAD_CATEGORIES[:2]))
    for sub, cats in need:
        for c in cats:
            if not os.path.isdir(os.path.join(data_root, sub, c)):
                make_mvtec_category(os.path.join(data_root, sub), c, img_size=img, n_train=12,
                                    n_test_good=3, n_test_defect=3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", default="",
                    help="dir holding mvtec_anomaly_detection/ and BTech_Dataset_transformed/")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ref-dir", default="reference",
                    help="reference repo root (csv_results_* live there)")
    ap.add_argument("--entries", default="", help="comma-separated subset of matrix entry names")
    ap.add_argument("--categories", default="", help="comma-separated category subset (debug)")
    ap.add_argument("--tolerance", type=float, default=0.005,
                    help="per-category image-AUROC gate (BASELINE.md: 0.5 pts)")
    ap.add_argument("--metrics", default="image_auroc_score",
                    help="comma-separated gated metrics")
    # tiny-config overrides (rehearsal / smoke)
    ap.add_argument("--epochs", type=int)
    ap.add_argument("--patience", type=int)
    ap.add_argument("--batch-size", type=int)
    ap.add_argument("--img-size", type=int)
    ap.add_argument("--num-gaussians", type=int)
    ap.add_argument("--rehearse", action="store_true",
                    help="synthetic end-to-end rehearsal: tiny data + tiny configs + stand-in "
                    "reference CSVs; exit 0 proves the harness plumbing")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits without a card) or cpu")
    args = ap.parse_args(argv)
    if not args.rehearse and not args.data_root:
        ap.error("--data-root is required (or use --rehearse)")

    from vit_ad_tpu_torch.config import check_device, set_numerics_policy

    device = check_device(args.device)
    set_numerics_policy()

    hp_overrides = {k: getattr(args, k) for k in HP_FLAGS if getattr(args, k) is not None}
    matrix = MATRIX
    if args.entries:
        want = set(args.entries.split(","))
        matrix = [e for e in matrix if e["name"] in want]
    categories = [c for c in args.categories.split(",") if c]
    metrics = [m for m in args.metrics.split(",") if m]

    data_root = args.data_root
    if args.rehearse:
        data_root = os.path.join(args.out, "synthetic_data")
        _make_rehearsal_data(data_root, matrix, img=hp_overrides.get("img_size", 32))
        hp_overrides = {**REHEARSAL_HP, **hp_overrides}
        matrix = rehearsal_matrix(matrix)

    summary = []
    all_ok = True
    for entry in matrix:
        ours_csv, rows = run_entry(entry, data_root, args.out, hp_overrides, categories or None,
                                   device)
        if args.rehearse:
            ref_csv = os.path.join(args.out, "stand_in_refs", entry["name"] + ".csv")
            _write_stand_in_reference(rows, ref_csv, metrics)
        else:
            ref_csv = os.path.join(args.ref_dir, entry["ref_csv"])
        ok, lines = compare_entry(ours_csv, ref_csv, args.tolerance, metrics)
        all_ok &= ok
        summary.append({"entry": entry["name"], "ok": ok, "ours": ours_csv, "ref": ref_csv})
        print(f"== {entry['name']}: {'OK' if ok else 'FAIL'}")
        for line in lines:
            print("   " + line)
    with open(os.path.join(args.out, "parity_summary.json"), "w") as f:
        json.dump({"ok": all_ok, "entries": summary}, f, indent=2)
    print(json.dumps({"parity_matrix_ok": all_ok, "entries": len(summary)}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
