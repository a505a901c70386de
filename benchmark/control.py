"""The check's control, for setting a cell's limits: the plain reference one
precision below what the configuration states (`reference/precision.py`),
put in the program's place and judged by the cell's numbers against the
float32 reference, on the cell's inputs at its own size, one line per seed.
Training cells also print each fault that the head can have
(`reference/train.FAULTS`: half of each batch left out; for the MDN, the pi
head left unmoved and its Gumbel noise left out), planted in the reference
put in the program's place and judged the same way. The benchmark's own
runs never run this.

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import torch

    from harness import runner, spec
    from reference.precision import set_f32_numerics

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    set_f32_numerics()
    cell = spec.load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        cells = runner.KINDS[cell.kind](cell, seed, device, program=False)
        out = cells.control()
        print(json.dumps({"workload": cell.name, "seed": seed, "readings": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del cells
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
