"""The port's soak-matrix tool (``tools/soak_matrix.py``) on the CPU,
against the JAX package's ``benchmarks/soak_r04.py`` and ``soak_r05.py``.

Each run's command is the JAX script's with only what the port changes:
the module, ``--fetch-every`` dropped, the UDP port base, the log and
spill directories, and ``--platform``; the labels, their order and their
time limits are the JAX scripts'. The reports carry the JAX ``_artifact``
keys. One real run at a toy size goes through ``paf_soak`` on the plain
versions (UDP ports probed free in 37000-37999).
"""

from __future__ import annotations

import ast
import json
import os
import socket
import sys

import pytest
import torch

from benchmarks import soak_r04 as J04
from benchmarks import soak_r05 as J05
from paf_baseband2power_tpu_torch.tools import soak_matrix as SM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"r04": (J04, "/tmp/soak_r04_{port}", 29900),
       "r05": (J05, "/tmp/soak_r05_{port}", 30100)}


def _jax_runs(name: str) -> list[tuple[str, list[str], int]]:
    """The JAX matrix's runs as ``(label, extra, time limit)``."""
    mod = JAX[name][0]
    if name == "r04":
        return [(label, extra, 900) for label, extra in mod.RUNS]
    return list(mod.RUNS)


def _jax_command(name: str, extra: list[str], port: int) -> list[str]:
    """The JAX script's command of one run (``main``'s list)."""
    mod, logdir, _ = JAX[name]
    return [sys.executable, "-m", "paf_baseband2power_tpu.cli.paf_soak",
            *mod.BASE_ARGS, *extra, "--port-base", str(port), "-k",
            logdir.format(port=port)]


def _ported(cmd: list[str], port: int, logdir: str, spill: str,
            platform: str) -> list[str]:
    """``cmd`` with the changes the port makes, and no other."""
    out = []
    skip = False
    for i, a in enumerate(cmd):
        if skip:
            skip = False
            continue
        if a == "--fetch-every":
            skip = True
            continue
        if a == "paf_baseband2power_tpu.cli.paf_soak":
            a = SM.SOAK
        elif a == "/tmp/soak_r05_spill":
            a = spill
        elif i and cmd[i - 1] == "-k":
            a = logdir
        out.append(a)
    return out + ["--platform", platform]


@pytest.mark.parametrize("name", ["r04", "r05"])
def test_commands_and_labels_equal_the_jax_scripts(name):
    base, runs, first = SM.MATRICES[name]
    jax_runs = _jax_runs(name)
    assert [r[0] for r in runs] == [r[0] for r in jax_runs]
    assert [r[2] for r in runs] == [r[2] for r in jax_runs]
    assert first == JAX[name][2]
    for k, ((_, extra, _), (_, jextra, _)) in enumerate(zip(runs,
                                                            jax_runs)):
        port = first + 10 * k
        got = SM.command(base, extra, port, "/logs", "/spill", "cpu")
        assert got == _ported(_jax_command(name, jextra, port), port,
                              "/logs", "/spill", "cpu")
    assert "--fetch-every" in J04.BASE_ARGS + J05.BASE_ARGS


def _artifact_keys(script: str) -> set[str]:
    """The keys of the dict that the JAX script's ``_artifact`` returns."""
    with open(os.path.join(REPO, "benchmarks", script)) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_artifact")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


@pytest.mark.parametrize("name", ["r04", "r05"])
def test_artifact_keys_equal_the_jax_scripts(name):
    runs = [{"label": "power device-layout #1", "loss": 0.01},
            {"label": "power wire", "loss": 0.0}]
    got = SM.artifact(name, runs, "env")
    assert set(got) == _artifact_keys(f"soak_{name}.py")
    assert got["runs"] == runs and got["environment"] == "env"
    if name == "r04":
        jax = J04._artifact(runs)["anomaly_diagnosis"]
        assert set(got["anomaly_diagnosis"]) == set(jax)
        assert got["anomaly_diagnosis"]["device_layout_losses_r4"] == \
            jax["device_layout_losses_r4"] == [0.01]


def _free_base(lo: int = 37000, hi: int = 37999) -> int:
    """A free UDP port base in a slice of ``[lo, hi]`` of this xdist
    worker's own."""
    span = (hi - lo) // 10
    slot = int(os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:] or 0)
    for i in range(span):
        base = lo + 10 * (((slot % 8) * (span // 8) + i) % span)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            try:
                s.bind(("127.0.0.1", base))
            except OSError:
                continue
        return base
    raise RuntimeError(f"no free UDP port in {lo}..{hi}")


def test_toy_run_passes_and_lands_in_the_report(monkeypatch, tmp_path,
                                                capsys):
    """One run of the r04 matrix's geometry, cut to 3 s; within three
    tries, as ``tests/test_torch_soak.py`` allows (capture's fall-behind
    quit is probabilistic on a shared host)."""
    toy = (["--seconds", "3", "--ndf", "1024", "--nports", "1", "--nblk",
            "8"], [("toy power", ["--rate", "0.5", "--nchk", "2"], 120)],
           0)
    monkeypatch.setitem(SM.MATRICES, "r04", toy)
    monkeypatch.chdir(tmp_path)
    for _ in range(3):
        rc = SM.main(["--matrix", "r04", "--platform", "cpu", "--port-base",
                      str(_free_base())])
        lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
        if rc == 0:
            break
    assert rc == 0, lines
    assert lines[-1] == {"ok": True, "failed": []}
    assert set(lines[0]) == set(SM.SUMMARY_KEYS["r04"])
    report = json.loads((tmp_path / "soak_matrix_cpu.json").read_text())
    run, = report["r04"]["runs"]
    assert run["label"] == "toy power" and run["pass"] is True
    assert run["backend"] == "cpu" and run["blocks_computed"] > 0
    assert set(report["r04"]) == _artifact_keys("soak_r04.py")
    assert "host cores" in report["r04"]["environment"]


def test_only_selects_runs_and_a_failed_run_fails_the_tool(monkeypatch,
                                                           tmp_path, capsys):
    ran = []

    def fake(cmd, timeout):
        ran.append(cmd)
        return {"mode": "power", "loss": 1.0, "pass": False}

    monkeypatch.setattr(SM, "run_one", fake)
    monkeypatch.chdir(tmp_path)
    assert SM.main(["--matrix", "r05", "--platform", "cpu", "--only",
                    "spill", "--port-base", str(_free_base())]) == 1
    labels = [label for label, _, _ in SM.RUNS_R05 if "spill" in label]
    assert len(ran) == len(labels) == 2
    assert all(cmd[cmd.index("--spill") + 1] != SM.SPILL for cmd in ran)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "ok": False, "failed": labels}


def test_soak_matrix_needs_a_gpu_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        SM.main([])
    assert e.value.code == 2
