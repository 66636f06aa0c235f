"""The port's benchmark entry point, ``paf_baseband2power_tpu_torch/bench.py``,
on the CPU against the repository's root ``bench.py``.

Each of its modes (the 10 of the matrix and every single-mode branch) runs
its step at 64 frames x 2 chunks beside the JAX function the root bench
calls for that mode: the matrix's Pallas kernels in interpret mode, the
single modes' XLA functions (what the root bench runs off the TPU) and, for
``--device-layout``, the fused Pallas PFB in interpret mode. Both of the
bench's function families run: the plain versions (``--impl torch``) and
the CUDA wrappers, which on a CPU tensor run the same plain versions, so
each wrapper is held at its place in the table.

Power and Stokes are bit-equal on blocks drawn in [-16, 16]: there every
partial sum of the JAX functions' float32 accumulation is an integer below
2^24, so exact, and the port's int64 sums must equal it to the bit. The
PFB runs on the bench's own range, [-256, 256), over two blocks with the
carry between them, within 2e-5 peak-normalized
(``benchmarks/parity_tpu.py:BOUND_PFB``).
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paf_baseband2power_tpu.ops import pallas_power as PP
from paf_baseband2power_tpu.ops import pfb as JPF
from paf_baseband2power_tpu.ops import power as JP
from paf_baseband2power_tpu.ops.pallas_pfb import pfb_spectra_fused
from paf_baseband2power_tpu_torch import bench as B
from paf_baseband2power_tpu_torch import constants as C
from paf_baseband2power_tpu_torch.ops import cuda_pfb as CF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDF, NCHK = 64, 2
BOUND_PFB = 2e-5
CPU = torch.device("cpu")
# the keys the port's single-mode line adds to the root bench's
SINGLE_EXTRA = {"block_ms", "hbm_fraction", "launches", "wrappers", "device"}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the small CPU blocks here (restored after):
    under several test workers, many threads on small tensors swamp the
    calls in scheduling."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(layout: str, seed: int, exact: bool) -> np.ndarray:
    """A numpy block: wire ``(NDF, NCHK * 3584)`` or rows ``(NCHK * 14,
    NDF, 256)`` int16, in [-16, 16] (``exact``) or [-256, 256)."""
    shape = ((NDF, NCHK * 3584) if layout == "wire"
             else (NCHK * 14, NDF, 256))
    lo, hi = (-16, 17) if exact else (-256, 256)
    return np.random.default_rng(seed).integers(lo, hi, size=shape,
                                                dtype=np.int16)


def _err(got, want) -> float:
    """Peak-normalized max error (``benchmarks/parity_tpu.py:_err``)."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _jax_carried(step2):
    """A JAX streaming ``step2(x, carry) -> (out, carry)`` over a list of
    blocks: the outputs."""
    def run(blocks):
        outs, carry = [], None
        for x in blocks:
            out, carry = step2(jnp.asarray(x), carry)
            outs.append(np.asarray(out))
        return outs
    return run


def _fused_rows(nfft, **kw):
    return _jax_carried(lambda x, h: pfb_spectra_fused(
        x, nfft, 4, history=h, return_history=True, layout="rows",
        interpret=True, **kw))


def _jax_one(fn):
    return lambda blocks: [np.asarray(fn(jnp.asarray(b))) for b in blocks]


# the root bench's matrix (``bench.py:bench_matrix``, its TPU branch):
# mode -> the JAX function it calls, on blocks of its layout
JAX_MATRIX = {
    "power": _jax_one(lambda x: PP.baseband2power_pallas(x, interpret=True)),
    "power rows": _jax_one(lambda x: PP.baseband2power_scrunch_rows_pallas(
        x, 1, interpret=True)),
    "stokes": _jax_one(lambda x: PP.baseband2stokes_pallas(
        x, interpret=True)),
    "scrunch[64]": _jax_one(lambda x: PP.baseband2power_scrunch_pallas(
        x, 64, interpret=True)),
    "stokes x scrunch[64]": _jax_one(
        lambda x: PP.baseband2stokes_scrunch_pallas(x, 64, interpret=True)),
    "stokes rows": _jax_one(
        lambda x: PP.baseband2stokes_scrunch_rows_pallas(x, 1,
                                                         interpret=True)),
    "stokes x scrunch[64] rows": _jax_one(
        lambda x: PP.baseband2stokes_scrunch_rows_pallas(x, 64,
                                                         interpret=True)),
    "pfb 128 rows streaming": _fused_rows(128),
    "pfb 128 x stokes rows streaming": _fused_rows(128, stokes=True),
    "pfb 1024 rows streaming": _fused_rows(1024),
}

# the root bench's single modes (``bench.py:main``, its CPU branches; the
# fused Pallas PFB in interpret mode for --device-layout): argv -> (the
# JAX function, the port's label with the CUDA wrappers, with the plain
# versions on the CPU)
SINGLE = {
    (): (_jax_one(JP.baseband2power_2d), "cuda", "torch cpu"),
    ("--stokes",): (_jax_one(JP.baseband2stokes_2d), "stokes cuda",
                    "stokes torch cpu"),
    ("--scrunch", "8"): (
        _jax_one(lambda x: JP.baseband2power_scrunch_2d(x, 8)),
        "scrunch cuda nout=8", "scrunch torch cpu nout=8"),
    ("--stokes", "--scrunch", "8"): (
        _jax_one(lambda x: JP.baseband2stokes_scrunch_2d(x, 8)),
        "stokes x scrunch cuda nout=8", "stokes x scrunch torch cpu nout=8"),
    ("--pfb", "128"): (_jax_carried(JPF.make_streaming_pfb(128, 4)),
                       "pfb nfft=128 [cuda]", "pfb nfft=128 [torch cpu]"),
    ("--pfb", "2048"): (
        _jax_carried(JPF.make_streaming_pfb(2048, 4)),
        "pfb nfft=2048 [torch.fft: nfft 2048 is outside the CUDA kernel's "
        "2..1024]", "pfb nfft=2048 [torch cpu]"),
    ("--pfb", "1024", "--stokes", "--scrunch", "2"): (
        _jax_carried(JPF.make_streaming_spectra(1024, 4, nout=2,
                                                stokes=True)),
        "pfb nfft=1024 x stokes x nout=2 [cuda]",
        "pfb nfft=1024 x stokes x nout=2 [torch cpu]"),
    ("--pfb", "1024", "--device-layout"): (
        _fused_rows(1024), "pfb nfft=1024 [device-layout rows] [cuda]",
        "pfb nfft=1024 [device-layout rows] [torch cpu]"),
    ("--pfb", "128", "--device-layout", "--stokes", "--scrunch", "2"): (
        _fused_rows(128, nout=2, stokes=True),
        "pfb nfft=128 [device-layout rows] x stokes x nout=2 [cuda]",
        "pfb nfft=128 [device-layout rows] x stokes x nout=2 [torch cpu]"),
}


def _blocks(layout: str, pfb: bool) -> list[np.ndarray]:
    """The mode's input blocks: two for the PFB (the carry crosses), one
    else."""
    return [_draw(layout, seed, exact=not pfb)
            for seed in ((1, 2) if pfb else (1,))]


def _hold(make_step, blocks, jax_run, pfb: bool) -> None:
    """A fresh step of each family, ``make_step(ops)``, over ``blocks``
    against the JAX function's outputs."""
    wants = jax_run(blocks)
    for impl in ("torch", "cuda"):
        step = make_step(B.ops_for(impl, CPU))
        for x, want in zip(blocks, wants):
            got = step(torch.from_numpy(x)).numpy()
            assert got.shape == want.shape
            if pfb:
                assert _err(got, want) < BOUND_PFB
            else:
                np.testing.assert_array_equal(got, want)


def _root_matrix_modes() -> list[str]:
    """The mode names of the root bench's matrix, read from its source."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "bench_matrix")
    on_tpu = next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                  and isinstance(n.test, ast.UnaryOp)
                  and getattr(n.test.operand, "id", None) == "on_tpu")
    modes = next(n for n in on_tpu.orelse if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "modes")
    return [t.elts[0].value for t in modes.value.elts]


def test_matrix_modes_are_the_root_benchs():
    assert [name for name, _, _ in B.MATRIX] == _root_matrix_modes()
    assert sorted(JAX_MATRIX) == sorted(_root_matrix_modes())


@pytest.mark.parametrize("name", [name for name, _, _ in B.MATRIX])
def test_matrix_mode_matches_the_root_benchs_kernel(name):
    layout, factory = next((lay, f) for n, lay, f in B.MATRIX if n == name)
    pfb = "pfb" in name
    _hold(factory, _blocks(layout, pfb), JAX_MATRIX[name], pfb)


@pytest.mark.parametrize("argv", list(SINGLE), ids=" ".join)
def test_single_mode_matches_the_root_benchs_function(argv):
    args = B.parser().parse_args(list(argv))
    jax_run, cuda_label, cpu_label = SINGLE[argv]
    labels = {impl: B.single_step(args, B.ops_for(impl, CPU))[0]
              for impl in ("cuda", "torch")}
    assert labels == {"cuda": cuda_label, "torch": cpu_label}
    layout = B.single_step(args, B.ops_for("torch", CPU))[1]
    pfb = "--pfb" in argv
    _hold(lambda ops: B.single_step(args, ops)[2], _blocks(layout, pfb),
          jax_run, pfb)


def test_pfb_route_follows_the_kernels_shapes():
    """On the CUDA wrappers a shape the kernel refuses goes to torch.fft
    on the card, as ``PowerPipeline`` routes it; the plain family keeps
    its own functions."""
    cuda = B.ops_for("cuda", CPU)
    assert B.pfb_route(cuda, 1024) == (CF.pfb_spectra_cuda,
                                       CF.pfb_power_cuda, "cuda")
    assert B.pfb_route(cuda, 2048)[:2] == (CF.pfb_spectra_torch,
                                           CF.pfb_power_torch)
    plain = B.ops_for("torch", CPU)
    assert B.pfb_route(plain, 2048) == (plain.pfb_spectra, plain.pfb_power,
                                        "torch cpu")


def test_blocks_are_drawn_from_the_seed():
    for make, shape in ((B.make_block_2d, (NDF, NCHK * 3584)),
                        (B.make_block_rows, (NCHK * 14, NDF, 256))):
        a = make(NDF, CPU, nchk=NCHK)
        assert a.shape == shape and a.dtype == torch.int16
        assert torch.equal(a, make(NDF, CPU, nchk=NCHK))
        assert not torch.equal(a, make(NDF, CPU, seed=1, nchk=NCHK))
        assert a.min() >= -256 and a.max() < 256


def test_matrix_line_on_cpu():
    """The matrix at 64 x 1 on the plain versions: the root bench's keys,
    one row per mode, no device metric and no launch on the CPU."""
    line = B.bench_matrix(NDF, 6, B.ops_for("torch", CPU), CPU, nchk=1)
    assert line["metric"].endswith("torch cpu)")
    assert line["unit"] == "samples/s" and line["value"] > 0
    assert line["vs_baseline"] == line["value"] / 796.4e6
    assert line["device"] == {"platform": "cpu", "kind": "cpu"}
    assert [r["mode"] for r in line["matrix"]] == _root_matrix_modes()
    for row in line["matrix"]:
        assert row["block_ms"] > 0 and row["samples_per_sec"] > 0
        assert row["hbm_fraction"] is None
        assert row["launches"] == 0 and row["wrappers"] == {}
    assert line["value"] == line["matrix"][0]["samples_per_sec"]


def test_cuda_mode_that_launches_nothing_is_an_error():
    """With the CUDA wrappers, a mode that launched no kernel (here: CPU
    tensors, which take the plain versions) is an error, not a row."""
    args = B.parser().parse_args(["--single"])
    with pytest.raises(RuntimeError, match="no CUDA kernel launched"):
        B.bench_single(args, NDF, B.ops_for("cuda", CPU), CPU, nchk=1)


def test_e2e_on_cpu_counts_its_blocks():
    line = B.bench_e2e(16, 6, B.ops_for("torch", CPU), CPU)
    assert line["value"] > 0 and line["value"] == line["vs_baseline"]
    assert line["unit"] == "x realtime" and line["depth"] == 2
    assert line["nblocks"] == 2 * (2 + 6)      # best of 2 at n1 and 3 n1
    assert line["kernel_launches"] == 0 and line["wrappers"] == {}
    assert line["block_stream_sec"] == 16 * C.TDF_SEC


@pytest.mark.parametrize("argv,message", [
    ([], "no CUDA device is available"),
    (["--platform", "cpu", "--h2d"], "no device to copy to"),
    (["--platform", "cpu", "--impl", "cuda"], "--impl cuda needs"),
    (["--platform", "cpu", "--pfb", "2048", "--device-layout"],
     "device-layout PFB supports"),
])
def test_usage_errors_exit_2(argv, message, capsys):
    if not argv and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        B.main(argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_quick_line_has_the_root_benchs_keys():
    """``--platform cpu --quick`` prints one JSON line with the keys and
    unit of the root bench's ``--quick --impl xla`` on the CPU, and the
    port's additions."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for cmd in ([sys.executable, "-m",
                          "paf_baseband2power_tpu_torch.bench", "--platform",
                          "cpu", "--quick"],
                         [sys.executable, "bench.py", "--quick", "--impl",
                          "xla"])]
    lines = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        assert len(out.strip().splitlines()) == 1
        lines.append(json.loads(out))
    port, root = lines
    assert set(root) == {"metric", "value", "unit", "vs_baseline"}
    assert set(port) == set(root) | SINGLE_EXTRA
    assert port["unit"] == root["unit"] == "samples/s"
    assert root["metric"].endswith(", xla)")
    assert port["metric"] == ("baseband samples/s/chip (unpack+detect+"
                              "integrate, torch cpu)")
    assert port["value"] > 0 and port["launches"] == 0
    assert port["device"] == {"platform": "cpu", "kind": "cpu"}
