"""The port's weak-scaling budget (``tools/scaling_budget.py``) on the CPU,
against the JAX package's ``benchmarks/scaling_budget.py`` (which imports
only ``json`` and ``os``).

The model's functions equal the JAX script's for the same inputs; the
port's payloads are the bytes its own collectives move (the int16 halo
of ``ops/pfb.py:pfb_history``, half the JAX model's complex64); the
table's rows follow the modes and fabrics given; the compute times come
only from the JSON the tool is given.
"""

from __future__ import annotations

import json

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from benchmarks import scaling_budget as JB
from paf_baseband2power_tpu_torch.ops import pfb as PF
from paf_baseband2power_tpu_torch.tools import scaling_budget as SB
from paf_baseband2power_tpu_torch.tools.spectra_bench import KERNEL_METHOD

payload = st.sampled_from([0, 1, 1344, 4 << 20, 352 << 20])
hosts = st.sampled_from([1, 2, 4, 8, 16, 32])
alpha = st.floats(1e-7, 1e-4)
bandwidth = st.floats(1e9, 1e12)


@settings(max_examples=200, deadline=None, database=None)
@given(payload, hosts, alpha, bandwidth)
def test_collective_times_equal_the_jax_scripts(p, n, a, bw):
    assert SB.t_allreduce(p, n, a, bw) == JB.t_allreduce(p, n, a, bw)
    assert SB.t_ppermute(p, n, a, bw) == JB.t_ppermute(p, n, a, bw)


@settings(max_examples=100, deadline=None, database=None)
@given(st.sampled_from(list(JB.COMPUTE_MS)), hosts, alpha, bandwidth)
def test_efficiency_equals_the_jax_scripts(mode, n, a, bw):
    assert SB.efficiency(mode, n, a, bw, JB.COMPUTE_MS, JB.payloads()) == \
        JB.efficiency(mode, n, a, bw)


def test_payloads_are_the_ports_bytes():
    """Same modes and keys as the JAX model; the halo and the carry are the
    port's int16 tails, half the JAX model's complex64, and the power
    all-reduce moves int64 sums."""
    got, want = SB.payloads(), JB.payloads()
    assert list(got) == list(want) == list(SB.COMPUTE_ROWS)
    assert all(set(got[m]) == set(want[m]) for m in got)
    halo = 336 * 2 * 3 * 1024 * 8                 # the JAX model's
    tail = PF.pfb_history(torch.zeros((24, 48 * 3584), dtype=torch.int16),
                          1024, 4)
    assert tail.nbytes == halo // 2
    pfb = "pfb1024 wire (time-shard)"
    assert got[pfb]["ppermute"] == tail.nbytes
    assert want[pfb]["psum"] - got[pfb]["psum"] == halo // 2
    assert got["power wire (time-shard)"]["psum"] == 336 * 8
    for mode in ("power rows (beam-DP)", "stokes rows (beam-DP)",
                 "pfb1024 rows (beam-DP)"):
        assert got[mode] == want[mode]


def _inputs(tmp_path, ms: float = 2.0):
    """A bench matrix line and a spectra_bench device-layout report in
    files, each row at ``ms`` plus its index."""
    matrix = {"metric": "m", "device": {"platform": "gpu", "kind": "card"},
              "matrix": [{"mode": m, "block_ms": ms + i} for i, m in
                         enumerate(["power", "power rows", "stokes rows",
                                    "pfb 1024 rows streaming"])]}
    spectra = {"measurements": {
        "pfb_streaming": [
            {"nfft": 1024, "layout": "wire", "method": "torch.fft",
             "block_ms": 60.0},
            {"nfft": 1024, "layout": "wire", "method": KERNEL_METHOD,
             "block_ms": ms + 10}],
        "composed": [{"nfft": 1024, "nout": 64, "stokes": False,
                      "layout": "wire", "block_ms": ms + 20}]}}
    mpath, spath = tmp_path / "matrix.json", tmp_path / "dl.json"
    mpath.write_text(json.dumps(matrix) + "\n")
    spath.write_text(json.dumps(spectra))
    return str(mpath), str(spath), matrix, spectra


def test_compute_times_come_from_the_rows_named(tmp_path):
    _, _, matrix, spectra = _inputs(tmp_path)
    ms, source = SB.compute_times(matrix, spectra)
    assert ms == {"power rows (beam-DP)": 3.0, "stokes rows (beam-DP)": 4.0,
                  "pfb1024 rows (beam-DP)": 5.0,
                  "power wire (time-shard)": 2.0,
                  "pfb1024 wire (time-shard)": 12.0,
                  "spectra nout=64 stokes nfft=1024 (time-shard)": 22.0}
    stand_in = [m for m, s in source.items() if "stand-in" in s]
    assert stand_in == ["spectra nout=64 stokes nfft=1024 (time-shard)"]
    del matrix["matrix"][1]
    with pytest.raises(LookupError, match="power rows"):
        SB.compute_times(matrix, spectra)


def test_table_rows_follow_the_modes_and_fabrics():
    ms = {m: 1.0 + i for i, m in enumerate(SB.COMPUTE_ROWS)}
    fabrics = dict(SB.DCN, **{"NVLink/NCCL (x)": (5e-6, 300e9)})
    rows, lines = SB.budget(ms, fabrics)
    want = [(m, f) for m in ms for f in fabrics
            if f.startswith("DCN") or "beam-DP" not in m]
    assert [(r["mode"], r["fabric"]) for r in rows[::len(SB.HOSTS)]] == want
    assert [r["hosts"] for r in rows] == SB.HOSTS * len(want)
    assert len(lines) == 2 + len(want)
    for r in rows:
        e, t = SB.efficiency(r["mode"], r["hosts"], *fabrics[r["fabric"]],
                             ms, SB.payloads())
        assert (r["efficiency"], r["block_s"]) == (e, t)
        assert r["deadline_frac"] == t / SB.DEADLINE_S


def test_alpha_beta_fit_recovers_the_model():
    for n, a, bw in ((4, 8e-6, 350e9), (8, 2e-5, 120e9)):
        secs = [SB.t_allreduce(p, n, a, bw) for p in SB.NCCL_SIZES]
        fa, fbw = SB.fit_alpha_beta(SB.NCCL_SIZES, secs, n)
        assert fa == pytest.approx(a) and fbw == pytest.approx(bw)


def test_main_writes_the_budget(tmp_path, monkeypatch, capsys):
    mpath, spath, _, _ = _inputs(tmp_path)
    nccl = tmp_path / "nccl.json"
    nccl.write_text(json.dumps({"ranks": 4, "alpha_s": 1e-5,
                                "bw_bytes_per_s": 3e11,
                                "device": {"kind": "card"}}))
    monkeypatch.chdir(tmp_path)
    assert SB.main(["--compute-json", mpath, "--spectra-json", spath]) == 0
    report = json.loads((tmp_path / "scaling_budget_cuda.json").read_text())
    jax_keys = {"deadline_s", "model", "compute_ms", "payload_bytes", "rows"}
    assert jax_keys <= set(report)
    assert set(report["fabrics"]) == set(SB.DCN)
    assert report["nvlink_nccl"].startswith("not measured")
    assert SB.main(["--compute-json", mpath, "--spectra-json", spath,
                    "--nccl-json", str(nccl)]) == 0
    report = json.loads((tmp_path / "scaling_budget_cuda.json").read_text())
    nvlink = [f for f in report["fabrics"] if f.startswith("NVLink")]
    assert len(nvlink) == 1 and "4 x card" in nvlink[0]
    out = capsys.readouterr().out
    assert out.count("NVLink") == 3        # the three time-sharded modes


@pytest.mark.parametrize("argv", [[], ["--compute-json", "m.json"],
                                  ["--spectra-json", "s.json"]])
def test_missing_compute_json_is_a_usage_error(argv):
    with pytest.raises(SystemExit) as e:
        SB.main(argv)
    assert e.value.code == 2


def test_measure_nccl_needs_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        SB.main(["--measure-nccl"])
    assert e.value.code == 2
