"""The run's result line and its exits: the keys the contract names, the
compared numbers last on both streams, no result without a card, and no
JAX in the processes that load the harness or the reference."""

import json
import os
import subprocess
import sys

import pytest
import torch
from _tiny import TINY

from portbench import run

ROOT = run.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _main(monkeypatch, capsys, cell, traced):
    """``run.main`` with the look for a card answered yes, on the CPU."""
    available = torch.cuda.is_available
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real = run.run_cell

    def on_cpu(manifest, cell, seed, seconds, traced, device, **kw):
        # past the look for a card, the profiler asks again
        monkeypatch.setattr(torch.cuda, "is_available", available)
        return real(manifest, cell, seed, 0.3, traced, torch.device("cpu"),
                    cfg_override=TINY, **kw)

    monkeypatch.setattr(run, "run_cell", on_cpu)
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 3),
                   "--seconds", "30", "--trace", str(int(traced))])
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["power.beams", "power.resident"])
def test_last_line_keys(monkeypatch, capsys, cell, traced):
    rc, out, err = _main(monkeypatch, capsys, cell, traced)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if traced else []) + ["check"]
    assert list(line) == want
    assert line["correct"] is True
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
    tail = err.strip().splitlines()[-len(line["check"]):]
    assert all(t.startswith("check ") and "limit" in t for t in tail)


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints nothing on
    standard output: it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "power.resident", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _top_level_modules(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    """The run module, every driver and the port's executor they build."""
    mods = _top_level_modules(
        "import torch\n"
        "from portbench import run, control, program\n"
        "for n in ('beams', 'resident'): run.load_driver(n)\n"
        "m = run.load_manifest()\n"
        "for x in m['end_to_end'] + m['per_layer']: "
        "run.load_reader(x['name'])\n"
        "cfg = run.load_config(m, 'paf_bmf_pfb1024')\n"
        "program.pipeline(torch.device('cpu'), cfg, 2)\n")
    assert "portbench" in mods and "paf_baseband2power_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "paf_baseband2power_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(
        "from portbench import check\n"
        "from portbench.references import power, pfb\n")
    assert not mods & {"jax", "jaxlib", "flax", "paf_baseband2power_tpu",
                       "paf_baseband2power_tpu_torch"}
