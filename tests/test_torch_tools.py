"""The port's last two tools: ``cli/paf_relayout.py`` held byte for byte
against the JAX package's, both ways, and ``cli/rebuild.py`` building the
host library and its debug, TSan and ASan variants into a build directory
of its own (its CUDA part needs ``nvcc``, which the test looks for itself
and skips without), with ``PAFB2P_NATIVE_LIB`` selecting a variant."""

from __future__ import annotations

import glob
import os
import subprocess
import sys

import pytest

from paf_baseband2power_tpu.cli import paf_relayout as jax_relayout
from paf_baseband2power_tpu_torch.cli import paf_gen
from paf_baseband2power_tpu_torch.cli import paf_relayout
from paf_baseband2power_tpu_torch.cli import rebuild
from paf_baseband2power_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("layout", ["wire", "rows"])
@pytest.mark.parametrize("nchk_flag", [[], ["--nchk", "4"]])
def test_relayout_byte_equal_to_jax_both_ways(tmp_path, layout, nchk_flag):
    src = str(tmp_path / "in.dada")
    paf_gen.main(["-o", src, "-n", "3", "--ndf", "16", "--nchk", "4"]
                 + (["--device-layout"] if layout == "rows" else []))
    out_p, out_j = str(tmp_path / "p.dada"), str(tmp_path / "j.dada")
    args = ["--ndf", "16"] + nchk_flag
    assert paf_relayout.main(["-a", src, "-b", out_p] + args) == 0
    assert jax_relayout.main(["-a", src, "-b", out_j] + args) == 0
    assert _bytes(out_p) == _bytes(out_j)
    # and back: the round trip restores the recording's payload
    back_p, back_j = str(tmp_path / "bp.dada"), str(tmp_path / "bj.dada")
    assert paf_relayout.main(["-a", out_p, "-b", back_p] + args) == 0
    assert jax_relayout.main(["-a", out_j, "-b", back_j] + args) == 0
    assert _bytes(back_p) == _bytes(back_j)
    assert _bytes(back_p)[4096:] == _bytes(src)[4096:]


@pytest.mark.parametrize("nblocks,argv,message", [
    ("1", ["--ndf", "5"], "not a whole number of"),
    ("0", ["--ndf", "16"], "no blocks converted"),
])
def test_relayout_errors_match_jax(tmp_path, nblocks, argv, message):
    src = str(tmp_path / "in.dada")
    paf_gen.main(["-o", src, "-n", nblocks, "--ndf", "16", "--nchk", "2"])
    errors = []
    for main in (paf_relayout.main, jax_relayout.main):
        with pytest.raises(SystemExit) as e:
            main(["-a", src, "-b", str(tmp_path / "o.dada")] + argv)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and message in errors[0]


def test_rebuild_host_variants(tmp_path, capsys):
    """Each variant under the hash of its own flags, built in a temporary
    directory and renamed into place; a rebuild removes and rebuilds."""
    build_dir = str(tmp_path / "build")
    assert rebuild.main(["--host-only", "--debug", "--tsan", "--asan",
                         "--build-dir", build_dir]) == 0
    paths = capsys.readouterr().out.split()[:4]
    names = sorted(os.path.basename(p) for p in paths)
    assert [n.split("-")[0] for n in names] == [
        "libpafb2p", "libpafb2p.asan", "libpafb2p.debug", "libpafb2p.tsan"]
    assert sorted(os.listdir(build_dir)) == names      # no temp dir left
    assert len({n.split("-")[1] for n in names}) == 4  # four hashes
    mtimes = {p: os.stat(p).st_mtime_ns for p in paths}
    assert rebuild.main(["--host-only", "--build-dir", build_dir]) == 0
    again = capsys.readouterr().out.split()[0]
    assert sorted(os.listdir(build_dir)) == [os.path.basename(again)]
    assert os.stat(again).st_mtime_ns >= mtimes[again]


def test_native_lib_variable_selects_a_variant(tmp_path, capsys):
    """``PAFB2P_NATIVE_LIB`` makes ``io/ringbuffer.py`` load that build
    (the debug variant here), and a ring works through it."""
    build_dir = str(tmp_path / "build")
    assert rebuild.main(["--host-only", "--debug",
                         "--build-dir", build_dir]) == 0
    debug = [p for p in capsys.readouterr().out.split()
             if ".debug-" in p][0]
    code = ("import uuid; from paf_baseband2power_tpu_torch.io import "
            "ringbuffer as rb\n"
            "lib = rb.load_library(); print(lib._name)\n"
            "k = uuid.uuid4().hex[:8]; rb.create(k, 4096, 2)\n"
            "assert rb.exists(k); rb.destroy(k)\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=REPO,
                                PAFB2P_NATIVE_LIB=debug),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == debug


def test_rebuild_cuda_library(tmp_path, capsys):
    """The full rebuild: the CUDA kernels' library with the host one."""
    if _build.find_nvcc() is None:
        pytest.skip("no nvcc: the CUDA library builds on a host with the "
                    "CUDA toolkit")
    build_dir = str(tmp_path / "build")
    assert rebuild.main(["--build-dir", build_dir]) == 0
    assert glob.glob(os.path.join(build_dir, "libpafb2p_cuda-*.so"))


def test_rebuild_without_nvcc_fails_with_the_reason(tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    assert rebuild.main(["--build-dir", str(tmp_path / "b")]) == 1
    assert "nvcc not found" in capsys.readouterr().err
