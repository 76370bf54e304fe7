"""The controls of the cells' checks: the plain reference with one of the
configuration's guarantees broken, put in the program's place and held to
the same comparison as a run's answers, at the cell's own size.

    python -m kbench.control --workload <name> --seeds <n> [<n> ...]

prints, for each seed, one JSON line with the numbers the control gives
beside the run's limits. Every control must give a number past its limit:
the kalign cell's reference at one mismatch fewer than kalign's limit (a
cut in sensitivity), the hammings cells' reference without the reverse
strand. The benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from . import run


def control_readings(bench: dict, workload: str, seed: int, device,
                     config=None, traffic=None) -> dict:
    """{check name: (control's number, limit)} for one seed; `config` and
    `traffic` replace the cell's files (the tests run small ones)."""
    import importlib
    cell, cfg, tr = run.cell_spec(bench, workload)
    cfg, tr = config or cfg, traffic or tr
    job_mod = importlib.import_module(f"kbench.jobs.{tr['job']}")
    with tempfile.TemporaryDirectory(prefix="kbench-control-") as tmp:
        return job_mod.Job(cfg, tr, seed, device, tmp).control()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kbench.control: CUDA is not available", file=sys.stderr)
        return 2
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control_readings(bench, args.workload, seed,
                               torch.device("cuda", 0))
        fails = any(v > lim for v, lim in got.values())
        failed_all &= fails
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_fails": fails,
                          "seconds": time.perf_counter() - t0,
                          "readings": {k: {"value": v, "limit": lim}
                                       for k, (v, lim) in got.items()}}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
