"""The live-topology soak matrices on the card: one tool for the JAX
package's ``benchmarks/soak_r04.py`` and ``benchmarks/soak_r05.py``.

Each run is its own process of ``python -m
paf_baseband2power_tpu_torch.cli.paf_soak`` (C++ sendmmsg sender -> UDP
capture over loopback -> shm ring -> CUDA compute -> sink, the reference's
full program ``paf-baseband2power.py:117-127``) with the JAX run's label,
arguments and time limit:

* ``r04``: power on wire and ``--device-layout`` (the latter three times,
  the JAX matrix's anomaly diagnosis), PFB x waterfall and PFB x Stokes as
  the live compute stage, and PFB x waterfall at the true 108 us cadence;
* ``r05``: the ring with ``NREADER=2`` and a raw-baseband spill beside
  compute (``--spill``, power and PFB), the sharded rows step
  (``--sharded-rows``), and two 60 s true-cadence runs at the production
  8192 frames per block.

Not carried over: ``--fetch-every`` (the port's soak has no such flag: the
JAX soak batched result fetches over its TPU link), the JAX scripts'
``PYTHONPATH`` of their TPU site and their ``JAX_PLATFORMS`` handling.
The log directories (``-k``) and the spill directory go under one
temporary directory, removed at the end. Each run's UDP ports are probed
free from ``--port-base`` up in steps of 10 (by default each matrix's own
base, 29900 or 30100, as the JAX scripts'), and the next run's search
starts 10 above the last run's base.

    python -m paf_baseband2power_tpu_torch.tools.soak_matrix
        [--matrix {r04,r05,all}] [--platform {cuda,cpu}]
        [--port-base N] [--only REGEX]

``--only``: the runs whose label matches. Prints one line per run (label,
mode, loss, blocks), then ``{"ok", "failed"}``; writes
``soak_matrix_<platform>.json`` (the JAX reports' keys, one entry per
matrix, with ``environment`` the card's name and power limit and the
host's cores) to the current directory after every run. Exits 1 if a run
failed, 2 for ``--platform cuda`` without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOAK = "paf_baseband2power_tpu_torch.cli.paf_soak"
SPILL = "{spill}"     # replaced by the spill directory of the run

# r04 (benchmarks/soak_r04.py:30-55), --fetch-every dropped
BASE_R04 = ["--seconds", "8", "--ndf", "1024", "--nports", "1",
            "--nblk", "8"]
RUNS_R04 = [
    ("power wire r3-continuity",
     ["--rate", "0.5", "--nchk", "2"]),
    ("power device-layout #1 (anomaly diagnosis)",
     ["--rate", "0.5", "--nchk", "2", "--device-layout"]),
    ("power device-layout #2",
     ["--rate", "0.5", "--nchk", "2", "--device-layout"]),
    ("power device-layout #3",
     ["--rate", "0.5", "--nchk", "2", "--device-layout"]),
    ("pfb128 x waterfall[64] device-layout (live fine channels)",
     ["--rate", "0.5", "--nchk", "2", "--device-layout",
      "--pfb", "128", "--nspectra", "64"]),
    ("pfb128 x stokes device-layout",
     ["--rate", "0.5", "--nchk", "2", "--device-layout",
      "--pfb", "128", "--stokes"]),
    ("pfb128 x waterfall[64] device-layout, TRUE 108us cadence",
     ["--rate", "1.0", "--nchk", "1", "--device-layout",
      "--pfb", "128", "--nspectra", "64"]),
]
TIMEOUT_R04 = 900

# r05 (benchmarks/soak_r05.py:33-61), --fetch-every dropped
BASE_R05 = ["--ndf", "1024", "--nports", "1", "--nblk", "8"]
RUNS_R05 = [
    ("power device-layout, full topology NREADER=2 spill",
     ["--seconds", "8", "--rate", "0.5", "--nchk", "2", "--device-layout",
      "--spill", SPILL], 900),
    ("pfb128 device-layout, full topology NREADER=2 spill",
     ["--seconds", "8", "--rate", "0.5", "--nchk", "2", "--device-layout",
      "--pfb", "128", "--spill", SPILL], 900),
    ("pfb128 sharded-rows streaming (shard_map live)",
     ["--seconds", "8", "--rate", "0.5", "--nchk", "2", "--device-layout",
      "--pfb", "128", "--sharded-rows"], 900),
    # the 60 s runs at the production 8192 frames per block: a 1024-frame
    # block is 110 ms of stream, so the fall-behind quit (2 blocks) fires
    # on any ~220 ms stall of the host; 884.7 ms blocks give it 1.77 s
    ("power device-layout, TRUE 108us cadence, 60 s, production ndf",
     ["--seconds", "60", "--rate", "1.0", "--nchk", "1", "--ndf", "8192",
      "--device-layout"], 1800),
    ("pfb128 x waterfall[64] device-layout, TRUE cadence, 60 s, "
     "production ndf",
     ["--seconds", "60", "--rate", "1.0", "--nchk", "1", "--ndf", "8192",
      "--device-layout", "--pfb", "128", "--nspectra", "64"], 1800),
]

# matrix -> (base arguments, [(label, extra, time limit)], first UDP port)
MATRICES = {
    "r04": (BASE_R04, [(lb, ex, TIMEOUT_R04) for lb, ex in RUNS_R04], 29900),
    "r05": (BASE_R05, RUNS_R05, 30100),
}
# the keys of each run's printed line, per matrix
SUMMARY_KEYS = {
    "r04": ("label", "mode", "loss", "blocks_computed", "expected_blocks",
            "pass"),
    "r05": ("label", "mode", "loss", "blocks_computed", "expected_blocks",
            "blocks_spilled", "pass"),
}


def free_udp_base(lo: int, nports: int) -> int:
    """The first base port from ``lo`` up, in steps of 10, whose ``nports``
    ports are all free UDP ports on the loopback."""
    for base in range(lo, lo + 1000, 10):
        socks = []
        try:
            for off in range(nports):
                socks.append(socket.socket(socket.AF_INET, socket.SOCK_DGRAM))
                socks[-1].bind(("127.0.0.1", base + off))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {nports} free UDP ports from {lo}")


def nports_of(args: list[str]) -> int:
    """The last ``--nports`` in ``args`` (paf_soak's own default, 2,
    without one)."""
    i = max((k for k, a in enumerate(args) if a == "--nports"), default=-1)
    return int(args[i + 1]) if i >= 0 else 2


def command(base: list[str], extra: list[str], port: int, logdir: str,
            spill: str, platform: str) -> list[str]:
    """One run's ``paf_soak`` command: the JAX run's, on the port's module,
    with ``--platform``."""
    extra = [spill if a == SPILL else a for a in extra]
    return [sys.executable, "-m", SOAK, *base, *extra, "--port-base",
            str(port), "-k", logdir, "--platform", platform]


def run_one(cmd: list[str], timeout: float) -> dict:
    """Run one soak; its report (the last stdout line), or an error
    report that does not pass."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    try:
        r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"error": f"timeout after {timeout}s", "pass": False}
    line = (r.stdout.strip().splitlines() or ["{}"])[-1]
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        return {"error": (r.stdout + r.stderr)[-400:], "pass": False}


def environment(platform: str) -> str:
    """The card's name and power limit (``nvidia-smi``) and the host's
    cores."""
    cores = len(os.sched_getaffinity(0))
    if platform == "cpu":
        return f"CPU only (the plain PyTorch versions); {cores} host cores"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().replace("\n", "; ")
    return (f"{smi}; {cores} host cores; UDP over the loopback of the "
            "card's host, sender and capture on the same cores")


def artifact(matrix: str, runs: list[dict], env: str) -> dict:
    """The JAX matrix's report (``_artifact``) for the port's runs."""
    date = time.strftime("%Y-%m-%d")
    reproduce = ["python -m paf_baseband2power_tpu_torch.tools.soak_matrix "
                 f"--matrix {matrix}"]
    if matrix == "r04":
        dl = [r for r in runs
              if r.get("label", "").startswith("power device-layout")]
        return {
            "what": "Live topology soaks on the card, the r04 matrix: "
                    "power on wire and device-layout rows, and the "
                    "composed fine-channel modes (PFB x waterfall, PFB x "
                    "Stokes) as the compute stage of the live capture -> "
                    "ring -> CUDA pipeline (paf-baseband2power.py:117-127 "
                    "with the planned channelizer, makefile:27).",
            "environment": env,
            "anomaly_diagnosis": {
                "question": "Does device-layout power lose frames where "
                            "the wire run at the same rate does not "
                            "(the corner turn's cost on the host), or do "
                            "repeated runs scatter (the host's variance)?",
                "device_layout_losses_r4": [r.get("loss") for r in dl
                                            if "loss" in r],
            },
            "runs": runs,
            "date": date,
            "reproduce": reproduce,
        }
    return {
        "what": "Live topology soaks on the card, the r05 matrix: the "
                "full reference topology (NREADER=2 ring with a raw "
                "baseband spill beside compute, paf-baseband2power.py:"
                "117-127), the sharded rows step as the live compute "
                "stage, and 60 s runs at the true cadence (rate 1.0, 108 "
                "us per frame) at the production 8192 frames per block.",
        "environment": env,
        "cadence_note": "The 60 s runs use 8192-frame blocks (884.7 ms of "
                        "stream each): the capture's fall-behind quit (2 "
                        "blocks behind, capture.c:491-509) then needs a "
                        "1.77 s stall of the host, where 1024-frame blocks "
                        "quit on 220 ms.",
        "runs": runs,
        "date": date,
        "reproduce": reproduce,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paf_baseband2power_tpu_torch.tools.soak_matrix")
    ap.add_argument("--matrix", choices=["r04", "r05", "all"],
                    default="all")
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--port-base", type=int, default=None,
                    help="the first UDP port to probe (default: each "
                    "matrix's own, 29900 and 30100)")
    ap.add_argument("--only", default=None, metavar="REGEX",
                    help="run only the runs whose label matches")
    args = ap.parse_args(argv)
    if args.platform == "cuda":
        import torch

        if not torch.cuda.is_available():
            ap.error("--platform cuda: no CUDA device is available "
                     "(--platform cpu runs the plain PyTorch versions)")
    out = f"soak_matrix_{args.platform}.json"
    env = environment(args.platform)
    names = ["r04", "r05"] if args.matrix == "all" else [args.matrix]
    report = {}
    bad = []
    with tempfile.TemporaryDirectory(prefix="soak_matrix-") as tmp:
        spill = os.path.join(tmp, "spill")
        os.makedirs(spill)
        for name in names:
            base, runs, port = MATRICES[name]
            if args.port_base is not None:
                port = args.port_base
            done = []
            for label, extra, timeout in runs:
                if args.only and not re.search(args.only, label):
                    continue
                port = free_udp_base(port, nports_of(base + extra))
                cmd = command(base, extra, port, os.path.join(
                    tmp, f"soak_{name}_{port}"), spill, args.platform)
                port += 10
                t0 = time.time()
                rep = run_one(cmd, timeout)
                rep["label"] = label
                rep["wall_sec"] = time.time() - t0
                done.append(rep)
                print(json.dumps({k: rep.get(k) for k in SUMMARY_KEYS[name]}),
                      flush=True)
                report[name] = artifact(name, done, env)
                with open(out, "w") as f:
                    json.dump(report, f, indent=1)
            bad += [r["label"] for r in done if not r.get("pass")]
    print(json.dumps({"ok": not bad, "failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
