"""Runs one benchmark cell once and prints its result as one JSON line.

    python3 -m kbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The cell is the entry of that name under `workloads` in BENCHMARK.json. Its
configuration is `kbench/configs/<config>.json`, its traffic
`kbench/traffic/<traffic>.json`, whose `job` names the job module
`kbench/jobs/<job>.py`; each per-layer metric `<name>` is read by
`kbench/metrics/<name>.py`.

A run: set-up (the job's inputs from the seed, the program's own set-up and
a warm-up of the cell's shapes), then the window: whole job units until
`--seconds` have passed, the unit in progress finished; then, with the
program's state freed, the check against the plain reference. With
`--trace 0` the result holds the cell's end-to-end metrics, with `--trace 1`
its per-layer metrics, read from torch.profiler over the window. The last
lines on standard error, and the result's last key, give each number the
check compared beside its limit; the run is correct where none is above
its limit.

It exits non-zero without a result where CUDA is missing or has fewer
cards than the cell asks for, and where jax, jaxlib, flax or the JAX
package kit4b_tpu was imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse      # noqa: E402
import gc            # noqa: E402
import importlib     # noqa: E402
import importlib.util  # noqa: E402
import json          # noqa: E402
import os            # noqa: E402
import shutil        # noqa: E402
import sys           # noqa: E402
import tempfile      # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kit4b_tpu")


class RunError(RuntimeError):
    """A run that can give no result."""


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose top-level name, compared whole, is one the
    benchmark must never load."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the cell named `workload`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def cell_metrics(bench: dict, cell: dict, trace: bool):
    """The metrics the cell reports: its end-to-end metrics, or with
    `trace` its per-layer ones (those that name the cell, or, naming none,
    move an end-to-end metric the cell reports)."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"kbench.metrics.{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a per-layer metric reader reads: the trace of the window, the
    units the window ran, the job's shapes and the card's name."""

    def __init__(self, trace, units: int, info: dict, card: str):
        self.trace, self.units, self.info, self.card = \
            trace, units, info, card


def run_window(job, seconds: float, sync) -> tuple[list[float], float]:
    """Whole units until `seconds` have passed; (each unit's end, in
    seconds from the window's start, and the seconds taken)."""
    t0 = time.perf_counter()
    ends = []
    while True:
        job.unit(len(ends))
        sync()
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            return ends, ends[-1]


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict,
             seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of a cell on `device` (a torch.device); the result dict."""
    import torch
    from . import trace as tracing
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    job_mod = importlib.import_module(f"kbench.jobs.{traffic['job']}")
    tmp = tempfile.mkdtemp(prefix="kbench-")
    try:
        t_inputs = time.perf_counter()
        job = job_mod.Job(config, traffic, seed, device, tmp)
        t_prepare = time.perf_counter()
        job.prepare()
        sync()
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        tr = None
        if trace:
            (ends, window_s), tr = tracing.profiled(
                lambda: run_window(job, seconds, sync), job_mod.SPANS)
        else:
            ends, window_s = run_window(job, seconds, sync)
        units = len(ends)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        job.free()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = job.check()
        check_s = time.perf_counter() - t_check
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        if trace:
            v = metric_reader(m["name"])(
                Context(tr, units, job.info, card))
        elif m["name"] == "setup_s":
            v = setup_s
        elif m["name"] == traffic["rate_metric"]:
            v = units * job.work_per_unit / window_s
        else:
            raise RunError(f"the cell reports {m['name']}, which its job "
                           f"does not measure")
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in checks.values())
    out = {"correct": correct,
           "attempted": units * job.work_per_unit, "failed": 0,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu", "kind": card,
                      "count": int(cell.get("chips", 1)),
                      "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"]["busy_s"] = tr.busy_s()
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["run"] = {"unit_ends_s": ends, "check_s": check_s,
                  "setup": {"start_s": t_inputs - t_start,
                            "inputs_s": t_prepare - t_inputs,
                            "prepare_s": t_window - t_prepare}}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def cache_dirs() -> None:
    """Kernel caches that torch or triton may write go to fixed
    directories inside the checkout (the port's own builds already sit in
    its `_build/`)."""
    cache = ROOT / ".kbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_dirs()
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        cell, config, traffic = cell_spec(bench, args.workload)
        import torch
        import kit4b_tpu_torch  # noqa: F401  (the program must be here)
        chips = int(cell.get("chips", 1))
        if not torch.cuda.is_available():
            raise RunError("CUDA is not available")
        if torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} cards, "
                           f"{torch.cuda.device_count()} are visible")
        out = run_cell(bench, cell, config, traffic, args.seed,
                       args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T_START)
    except (RunError, ImportError, OSError, KeyError) as e:
        print(f"kbench: no result: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print(f"kbench: no result: modules the benchmark must not load "
              f"were loaded: {', '.join(loaded)}", file=sys.stderr)
        return 2
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
