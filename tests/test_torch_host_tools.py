"""The port's measurement tools (``paf_baseband2power_tpu_torch/tools``) on
the CPU, against the JAX package's scripts in ``benchmarks/``.

``host_runtime``'s three functions run at small sizes beside the JAX
script's own (which run on the JAX package's ring, capture engine and
sender) and return reports with the same keys. ``multibeam`` and
``scaling`` run on gloo ranks on the CPU: their reports carry the JAX
scripts' keys (read from those scripts' source, which would need JAX
devices to run), every multibeam record equals the serial pipeline's, and
every scaling point's output equals the single-device step's. UDP ports
are probed free in 36000-36999.
"""

from __future__ import annotations

import ast
import json
import os
import socket

import pytest
import torch

from benchmarks import host_runtime as JH
from paf_baseband2power_tpu_torch.runtime import multibeam as RMB
from paf_baseband2power_tpu_torch.tools import host_runtime as H
from paf_baseband2power_tpu_torch.tools import multibeam as MB
from paf_baseband2power_tpu_torch.tools import scaling as SC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_udp_ports(n: int, lo: int = 36000, hi: int = 36999) -> int:
    """The first of ``n`` consecutive free UDP ports in ``[lo, hi]``, the
    search started in a slice of the range of this xdist worker's own, so
    that two workers never probe the same base while one of them has yet
    to bind it."""
    span = (hi - lo) // 10
    slot = int(os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:] or 0)
    for i in range(span):
        base = lo + 10 * (((slot % 8) * (span // 8) + i) % span)
        socks = []
        try:
            for p in range(n):
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                socks.append(s)
                s.bind(("127.0.0.1", base + p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} free UDP ports in {lo}..{hi}")


def _dict_keys(script: str, where) -> set[str]:
    """The keys of the dict literal in ``benchmarks/<script>`` that
    ``where(node)`` picks."""
    with open(os.path.join(REPO, "benchmarks", script)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and where(node):
            return {k.value for k in node.keys}
    raise LookupError(script)


def _has_key(name: str):
    return lambda node: any(isinstance(k, ast.Constant) and k.value == name
                            for k in node.keys)


# --- host_runtime -------------------------------------------------------------


def test_ring_report_keys_equal_the_jax_scripts():
    got = H.bench_ring(block_mb=1, nblocks=4)
    assert set(got) == set(JH.bench_ring(block_mb=1, nblocks=4))
    assert got["GBps"] > 0 and (got["block_mb"], got["nblocks"]) == (1, 4)


def test_sender_report_keys_equal_the_jax_scripts():
    kw = dict(nchk=2, nports=1, nframes=2000)
    got = H.bench_sender_only(port_base=free_udp_ports(1), **kw)
    want = JH.bench_sender_only(port_base=free_udp_ports(1), **kw)
    assert set(got) == set(want)
    assert got["frames_per_sec"] > 0 and got["burst"] in (8, 16, 64, 256)


def test_capture_report_keys_equal_the_jax_scripts():
    kw = dict(seconds=0.2, nchk=2, nports=1)
    got = H.bench_capture(port_base=free_udp_ports(1), **kw)
    want = JH.bench_capture(port_base=free_udp_ports(1), **kw)
    assert set(got) == set(want)
    assert got["received_frames"] > 0
    assert 0 < got["received_fraction"] <= 1


def test_host_runtime_main_writes_the_jax_scripts_report(monkeypatch,
                                                         tmp_path, capsys):
    for fn in ("bench_ring", "bench_sender_only", "bench_capture"):
        monkeypatch.setattr(H, fn, lambda fn=fn, **kw: {"ran": fn, **kw})
    out = tmp_path / "host.json"
    assert H.main(["--out", str(out), "--port-base", "36100"]) == 0
    report = json.loads(out.read_text())
    assert report == json.loads(capsys.readouterr().out)
    assert set(report) == _dict_keys("host_runtime.py",
                                     _has_key("physical_cores"))
    assert report["ring"] == {"ran": "bench_ring"}
    assert report["capture"] == {"ran": "bench_capture", "port_base": 36100}
    assert report["sender_only"] == {"ran": "bench_sender_only",
                                     "port_base": 36500}


# --- multibeam ----------------------------------------------------------------


def test_multibeam_on_gloo_ranks(capsys):
    """Two beams on two CPU ranks: the run passes only if every multibeam
    record equals the serial pipeline's."""
    assert MB.main(["--platform", "cpu", "--ranks", "2", "--ndf", "16",
                    "--nchk", "8", "--nblocks", "3"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == _dict_keys("multibeam.py", _has_key("nbeam"))
    assert report["mesh"] == {"beam": 2, "time": 1, "chunk": 1}
    assert (report["nbeam"], report["blocks"],
            report["nblocks_per_beam"]) == (2, 3, 3)
    assert report["serial_per_beam_sec"] > 0 and report["multibeam_sec"] > 0


@pytest.mark.parametrize("corrupt", [False, True])
def test_multibeam_rank_holds_records_against_the_pipeline(monkeypatch,
                                                           corrupt):
    """One rank in this process (a one-rank group): the records compare
    equal, and a changed record does not."""
    run = RMB.run_multibeam

    def spoiled(sources, mesh, sinks, **kw):
        stats = run(sources, mesh, sinks, **kw)
        sinks[0].records[-1] = sinks[0].records[-1] * 2
        return stats

    if corrupt:
        monkeypatch.setattr(RMB, "run_multibeam", spoiled)
    for var in ("PAFB2P_COORDINATOR", "PAFB2P_NUM_PROCS", "PAFB2P_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    args = MB.build_parser().parse_args(
        ["--platform", "cpu", "--nbeam", "1", "--ndf", "16", "--nchk", "4",
         "--nblocks", "2"])
    args.backend = "gloo"
    report, equal = MB.rank_main(args)
    assert equal is not corrupt
    assert report["blocks"] == 2 and report["mesh"] == {
        "beam": 1, "time": 1, "chunk": 1}


# --- scaling ------------------------------------------------------------------


def test_scaling_on_gloo_ranks(tmp_path, capsys):
    out = tmp_path / "scaling.json"
    assert SC.main(["--platform", "cpu", "--ranks", "2", "--ndf-per-dev",
                    "16", "--iters", "2", "--out", str(out)]) == 0
    points = [json.loads(line) for line in
              capsys.readouterr().out.strip().splitlines()]
    keys = _dict_keys("scaling.py", _has_key("weak_scaling_eff"))
    assert [set(p) for p in points] == [keys, keys]
    assert [p["devices"] for p in points] == [1, 2]
    assert points[0]["weak_scaling_eff"] == 1.0
    assert all(p["samples_per_sec"] > 0 for p in points)
    report = json.loads(out.read_text())
    assert _dict_keys("scaling.py", _has_key("virtual_mesh")) <= set(report)
    assert report["points"] == points and report["virtual_mesh"] is True
    assert report["dist_backend"] == {"1": "gloo", "2": "gloo"}


def test_scaling_rank_output_equals_the_single_device_step(monkeypatch):
    """One rank in this process: the sharded step's gathered output
    equals the kernel's on the whole block."""
    for var in ("PAFB2P_COORDINATOR", "PAFB2P_NUM_PROCS", "PAFB2P_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    args = SC.build_parser().parse_args(
        ["--platform", "cpu", "--ndf-per-dev", "8", "--iters", "1"])
    args.backend = "gloo"
    result = SC.rank_main(args)
    assert result["equal"] is True and result["samples_per_sec"] > 0


@pytest.mark.parametrize("tool", [MB, SC])
def test_tools_need_a_gpu_for_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tool.main([])
    assert e.value.code == 2

