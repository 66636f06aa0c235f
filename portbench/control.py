"""Readings for the limits of ``correct``: the compared numbers of a cell on
many seeds in one process, for the program or for the control.

    python -m portbench.control --workload <cell> --seeds 1,2,3 \
        --seconds <s> --which program|control

The control is the configuration's plain reference in the next precision
down (``references/<name>.py:control``), run by the same driver through
the executor in the program's place. Each seed prints one JSON line with
the numbers compared; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, run


def readings(cell: str, seeds: list[int], seconds: float, which: str,
             device: torch.device, cfg_override: dict | None = None):
    """Yield ``(seed, result)`` for each seed."""
    manifest = run.load_manifest()
    step_for = None
    if which == "control":
        def step_for(cfg):
            return check.reference_module(cfg).control(cfg)
    for seed in seeds:
        result, _ = run.run_cell(manifest, cell, seed, seconds, False,
                                 device, step_for=step_for,
                                 cfg_override=cfg_override)
        yield seed, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--which", choices=("program", "control"),
                    default="control")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, res in readings(args.workload, seeds, args.seconds,
                              args.which, torch.device("cuda", 0)):
        print(json.dumps({"workload": args.workload, "which": args.which,
                          "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"], "check": res["check"],
                          "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
