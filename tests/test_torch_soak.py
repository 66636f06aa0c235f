"""The port's real-time soak on the CPU (``--platform cpu``): UDP capture ->
ring -> compute at a paced rate, at ``tests/test_soak.py``'s parameters and
with its retries (the fall-behind policy under test is itself probabilistic
when the OS preempts capture on an oversubscribed host). Ports are probed
free in a range no other test file uses."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"backend", "mode", "seconds", "rate_x_realtime", "sender",
        "frames_streamed", "stream_elapsed", "loss", "blocks_captured",
        "blocks_computed", "expected_blocks", "force_switches", "warmup_sec",
        "compute_realtime_x", "kernel_launches", "pass"}


def free_port_base(nports, lo):
    for base in range(lo, lo + 400, 10):
        socks = []
        try:
            for i in range(nports):
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free ports")


def run_soak(args, tmp_path, timeout=180):
    r = subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu_torch.cli.paf_soak",
         *args, "-k", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=timeout)
    return r, (json.loads(r.stdout.strip().splitlines()[-1])
               if r.stdout.strip() else None)


def soak_passes(args, nports, lo, tmp_path, attempts=3):
    """The soak's report once it passes; up to ``attempts`` runs, 5 s
    apart, each on freshly probed ports."""
    last = None
    for attempt in range(attempts):
        if attempt:
            time.sleep(5)
        base = free_port_base(nports, lo + 100 * attempt)
        r, report = run_soak(args + ["--nports", str(nports), "--port-base",
                                     str(base), "--platform", "cpu"],
                             tmp_path)
        try:
            assert r.returncode == 0, r.stdout + r.stderr
            assert set(report) - KEYS <= {"blocks_spilled", "spill_path"}
            assert KEYS <= set(report)
            assert report["pass"] and report["loss"] <= 0.05, report
            assert report["blocks_computed"] >= report["expected_blocks"] - 1
            assert report["backend"] == "cpu"
            assert report["kernel_launches"] == 0    # no kernel on the CPU
            return report
        except AssertionError as e:  # pragma: no cover - load dependent
            last = e
    raise last


@pytest.mark.parametrize("layout", ["wire", "device-layout"])
def test_soak_realtime_native_sender(tmp_path, layout):
    """Rate 1.0, the C++ sendmmsg sender, 3 s at 1024 x 2: capture -> ring
    -> compute holds real time; ``--device-layout`` consumes series rows."""
    extra = ["--device-layout"] if layout == "device-layout" else []
    report = soak_passes(["--seconds", "3", "--rate", "1.0", "--ndf", "1024",
                          "--nchk", "2", "--nblk", "8"] + extra, 1,
                         30500 if extra else 31000, tmp_path)
    assert report["sender"] == "native"
    assert report["stream_elapsed"] < 3.0 * 1.1
    assert report["mode"] == "power" + ("  [device-layout rows]"
                                        if extra else "")
    assert report["frames_streamed"] == int(3 / 1.08e-4) * 2


def test_soak_python_sender(tmp_path):
    report = soak_passes(["--seconds", "3", "--rate", "0.05", "--sender",
                          "py"], 2, 31500, tmp_path)
    assert report["sender"] == "py" and report["rate_x_realtime"] == 0.05


def test_soak_pfb_spill_tap(tmp_path):
    """The PFB as the compute stage with a raw-baseband spill on a second
    reader (NREADER 2): every captured block is spilled."""
    spill = tmp_path / "spill"
    spill.mkdir()
    report = soak_passes(["--seconds", "2", "--rate", "0.25", "--ndf", "256",
                          "--nchk", "2", "--device-layout", "--pfb", "128",
                          "--nspectra", "2", "--spill", str(spill)], 1,
                         32000, tmp_path)
    assert report["mode"].startswith("pfb128+waterfall[2]")
    assert report["blocks_spilled"] == report["blocks_captured"]
    assert os.path.exists(report["spill_path"])


def test_soak_cuda_exits_nonzero_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --platform cuda would run")
    r, report = run_soak(["--seconds", "1"], tmp_path, timeout=60)
    assert r.returncode == 2 and report is None
    assert "no CUDA device" in r.stderr


def test_soak_sharded_rows(tmp_path):
    """``--sharded-rows``: the compute stage is the per-rank step of
    ``make_sharded_rows_step`` (a one-rank chunk mesh, the streaming rows
    carry) in place of the pipeline's own PFB step."""
    report = soak_passes(["--seconds", "2", "--rate", "0.25", "--ndf", "256",
                          "--nchk", "2", "--device-layout", "--pfb", "128",
                          "--nspectra", "2", "--sharded-rows"], 1, 32500,
                         tmp_path)
    assert report["mode"] == ("pfb128+waterfall[2]  [device-layout rows]"
                              "  [sharded-rows]")


@pytest.mark.parametrize("flags", [["--pfb", "128"], ["--device-layout"]])
def test_soak_sharded_rows_needs_device_layout_and_pfb(tmp_path, flags):
    r, report = run_soak(["--sharded-rows", "--platform", "cpu", *flags],
                         tmp_path, timeout=60)
    assert r.returncode == 2 and report is None
    assert "--sharded-rows needs --device-layout and --pfb" in r.stderr
