"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``), which names its driver
(``drivers/<driver>.py``); each metric the cell reports is read by
``metrics/<metric>.py``. With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window. After the window every record is
judged against the configuration's plain reference (``check.py``); the
numbers compared, each beside its limit, are the last lines on standard
error and the last key of the line. The line before them gives the
comparison's time, the record arrays kept (``stream.Records``) and the
process's peak host RSS.

It needs as many CUDA devices as the cell asks for, and exits 2 without
printing a result when there are fewer.
"""

from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from . import check  # noqa: E402
from . import trace as T  # noqa: E402
from .stream import Clock  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "paf_baseband2power_tpu")


def load_manifest(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named '{name}' in BENCHMARK.json")


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_config(manifest: dict, name: str) -> dict:
    entry = find(manifest["configs"], name, "configuration")
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    return load_json("traffic", f"{name}.json")


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def load_reader(metric: str):
    """``metrics/<metric>.py`` as a module (its name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    modname = "portbench.metrics." + metric.replace(".", "__")
    if modname not in sys.modules:
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
    return sys.modules[modname]


def cell_metrics(manifest: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics ``cell`` reports: per-layer ones when traced, else the
    end-to-end ones; a metric without ``workloads`` is in every cell."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Context:
    """What metric readers read."""
    cell: str
    cfg: dict
    traffic: dict
    streams: list
    clock: Clock
    setup_s: float
    trace: T.Trace | None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device: torch.device, count: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": peak}


def run_cell(manifest: dict, cell: str, seed: int, seconds: float,
             traced: bool, device: torch.device, step_for=None,
             cfg_override: dict | None = None):
    """Run ``cell`` once on ``device``; returns ``(result, verdict)``.

    ``step_for(cfg)`` gives a step to run in the program's place (the
    control; faults in the tests). ``cfg_override`` replaces keys of the
    configuration (tiny blocks in the tests)."""
    work = find(manifest["workloads"], cell, "workload")
    cfg = dict(load_config(manifest, work["config"]), **(cfg_override or {}))
    traffic = load_traffic(work["traffic"])
    driver = load_driver(traffic["driver"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    step = step_for(cfg) if step_for else None
    session = driver.setup(cfg, traffic, seed, device, step, traced)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    clock = Clock()
    setup_s = time.perf_counter() - PROCESS_T0
    prof = T.start() if traced else None
    session.window(seconds, clock)
    tr = T.reduce(prof, clock.t0_ns, clock.t1_ns) if traced else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    streams = session.streams
    session.close()
    verdict = check.compare(cfg, streams, session.pool_block)
    ctx = Context(cell, cfg, traffic, streams, clock, setup_s, tr)
    metrics = {}
    for m in cell_metrics(manifest, cell, traced):
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(device, work["chips"], peak)
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
    result = {"correct": verdict.correct, "attempted": verdict.attempted,
              "failed": verdict.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["check"] = verdict.numbers
    return result, verdict


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    manifest = load_manifest()
    work = find(manifest["workloads"], args.workload, "workload")
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < work["chips"]:
        print(f"the cell needs {work['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, verdict = run_cell(manifest, args.workload, args.seed,
                               args.seconds, bool(args.trace),
                               torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"reference and comparison: {verdict.seconds:.1f} s; records "
          f"kept: {sum(verdict.kept)} arrays (a stream: {verdict.kept}), "
          f"{verdict.kept_bytes / 1e6:.2f} MB; peak host RSS: "
          f"{rss / 1e9:.2f} GB", file=sys.stderr)
    sys.stderr.write("\n".join(verdict.lines()) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
