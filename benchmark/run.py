"""Run one cell of the port's benchmark once, on the machine it is started on.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `benchmark/` and
the port `vit_ad_tpu_torch/`. Needs a CUDA card (it never falls back to the
CPU). Prints the launches, the card and its power limit and the timings on
earlier lines, the checked numbers with their limits as the last lines on
standard error, and the result object as the last line on standard output.
The port builds its kernel library inside the checkout
(`vit_ad_tpu_torch/_build/`), so only a checkout's first run builds it.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import torch

    t_torch = time.perf_counter() - T_PROCESS

    from harness import runner, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    print(f"card: {runner.power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"start and torch imported at {t_torch:.3f} s", flush=True)
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), T_PROCESS,
                        log=lambda s: print(s, flush=True))
    runner.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
