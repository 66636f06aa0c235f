"""Analytic weak-scaling budget from the card's own block times: expected
efficiency at 2-32 hosts.

The port's copy of the JAX package's ``benchmarks/scaling_budget.py``. For
each deployment layout it models the per-block communication against the
0.884736 s real-time deadline (README.md:2) and the single-card compute
time per block, over a range of fabrics.

Model (alpha-beta, as the JAX script's): an all-reduce of P bytes over N
participants as a ring costs ``2(N-1)(alpha + (P/N)/B)``; a point-to-point
send of P bytes ``alpha + P/B``. Efficiency is ``T1 / (T1 + Tcomm)``, with
no overlap of compute and communication (a lower bound: the pipeline
overlaps blocks). Weak scaling means more hosts = more beams; the beam
axis is pure data parallelism.

Compute times are not built in: they are the card's, read from the JSON
line of the port's bench matrix (``python -m
paf_baseband2power_tpu_torch.bench > matrix.json``, ``--compute-json``)
and from ``tools/spectra_bench.py``'s ``DEVICE_LAYOUT_cuda.json``
(``--spectra-json``), mode by mode as ``COMPUTE_ROWS`` maps them. The
composed Stokes x 64 waterfall at nfft 1024 has no row in either; its
stand-in is the composed ``(1024, 64, False)`` wire row, named so in the
report.

Payloads are the bytes the port's own collectives move
(``parallel/sharded.py``), not the JAX model's: power and Stokes reduce
exact int64 sums (``_reduced_detect``: ``time.all_reduce(sums)``), the PFB
halo and the carry cross ranks as the int16 tails of ``ops/pfb.py:
pfb_history`` (``_pfb_beams``: ``time.shift_up(tails)`` and
``time.broadcast_from_last(tails)``), 4 bytes a complex sample where the
JAX model counts complex64, 8.

Fabrics: two DCN figures (100-200 Gb/s NICs, 25 us), and NVLink through
NCCL as measured on the card's host by ``--measure-nccl``: an all-reduce
of float32 at two payload sizes across every card of the host (one
process per card), whose two times give the model's alpha and bandwidth.
Without ``--nccl-json`` (that measurement's report) the NVLink row is
left out, and the report says so.

    python -m paf_baseband2power_tpu_torch.tools.scaling_budget \\
        --compute-json matrix.json --spectra-json DEVICE_LAYOUT_cuda.json \\
        [--nccl-json nccl_allreduce_cuda.json]
    python -m paf_baseband2power_tpu_torch.tools.scaling_budget \\
        --measure-nccl

Writes ``scaling_budget_<platform>.json`` (or
``nccl_allreduce_cuda.json``) to the current directory and prints the
markdown table (or the measurement's line).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .spectra_bench import KERNEL_METHOD

DEADLINE_S = 0.884736
NCHAN = 336
NPOL = 2
HOSTS = [2, 4, 8, 16, 32]
# mode -> (the report it is read from, the row's match, stand-in or not)
COMPUTE_ROWS = {
    "power rows (beam-DP)": ("matrix", {"mode": "power rows"}, False),
    "stokes rows (beam-DP)": ("matrix", {"mode": "stokes rows"}, False),
    "pfb1024 rows (beam-DP)": ("matrix", {"mode": "pfb 1024 rows streaming"},
                               False),
    "power wire (time-shard)": ("matrix", {"mode": "power"}, False),
    "pfb1024 wire (time-shard)": (
        "pfb_streaming", {"nfft": 1024, "layout": "wire",
                          "method": KERNEL_METHOD}, False),
    "spectra nout=64 stokes nfft=1024 (time-shard)": (
        "composed", {"nfft": 1024, "nout": 64, "stokes": False,
                     "layout": "wire"}, True),
}
DCN = {
    "DCN (12.5 GB/s, 25 us)": (25e-6, 12.5e9),
    "DCN (25 GB/s, 25 us)": (25e-6, 25e9),
}
NCCL_SIZES = (1 << 16, 1 << 28)     # bytes of the measured all-reduces
NCCL_OUT = "nccl_allreduce_cuda.json"


def payloads(nfft=1024, ntap=4, nout=64, stokes=True):
    """Bytes per block of each collective of each mode, as the port's
    ``parallel/sharded.py`` moves them."""
    halo = NCHAN * NPOL * (ntap - 1) * nfft * 4     # int16 (re, im) tails
    return {
        # beam-DP rows: no collective on the data; rank 0 gathers the
        # per-beam float32 records
        "power rows (beam-DP)": {"psum": 0, "ppermute": 0,
                                 "gather": NCHAN * 4},
        "stokes rows (beam-DP)": {"psum": 0, "ppermute": 0,
                                  "gather": 4 * NCHAN * 4},
        "pfb1024 rows (beam-DP)": {"psum": 0, "ppermute": 0,
                                   "gather": NCHAN * nfft * 4},
        # time-sharded wire: the all-reduce of int64 partial sums (power)
        # or float32 spectra plus the int16 carry's broadcast, the halo
        # sent to the next shard, the records gathered
        "power wire (time-shard)": {"psum": NCHAN * 8, "ppermute": 0,
                                    "gather": NCHAN * 4},
        "pfb1024 wire (time-shard)": {
            "psum": NCHAN * nfft * 4 + halo,
            "ppermute": halo,
            "gather": NCHAN * nfft * 4},
        "spectra nout=64 stokes nfft=1024 (time-shard)": {
            "psum": nout * 4 * NCHAN * nfft * 4 + halo,
            "ppermute": halo,
            "gather": nout * 4 * NCHAN * nfft * 4},
    }


def t_allreduce(p_bytes, n, alpha, bw):
    if p_bytes == 0 or n <= 1:
        return 0.0
    return 2 * (n - 1) * (alpha + (p_bytes / n) / bw)


def t_ppermute(p_bytes, n, alpha, bw):
    if p_bytes == 0 or n <= 1:
        return 0.0
    return alpha + p_bytes / bw


def efficiency(mode, n, alpha, bw, compute_ms, payload):
    """``(efficiency, seconds per block)`` of ``mode`` at ``n`` hosts, from
    its compute ms (``compute_ms[mode]``) and payloads
    (``payload[mode]``)."""
    t1 = compute_ms[mode] / 1e3
    p = payload[mode]
    comm = (t_allreduce(p["psum"], n, alpha, bw)
            + t_ppermute(p["ppermute"], n, alpha, bw))
    # the small gather is batched and overlapped; counted at full cost
    comm += t_ppermute(p["gather"], n, alpha, bw)
    return t1 / (t1 + comm), (t1 + comm)


def compute_times(matrix: dict, spectra: dict) -> tuple[dict, dict]:
    """``(ms per block, where each came from)`` by mode, from the bench
    matrix's line and spectra_bench's device-layout report; raises
    ``LookupError`` for a row that is not there."""
    tables = {"matrix": matrix["matrix"],
              "pfb_streaming": spectra["measurements"]["pfb_streaming"],
              "composed": spectra["measurements"]["composed"]}
    ms, source = {}, {}
    for mode, (table, match, stand_in) in COMPUTE_ROWS.items():
        rows = [r for r in tables[table]
                if all(r.get(k) == v for k, v in match.items())]
        if not rows:
            raise LookupError(f"{mode}: no {table} row {match}")
        ms[mode] = rows[0]["block_ms"]
        tool = "bench" if table == "matrix" else "spectra_bench"
        source[mode] = (f"{tool} {table} row {json.dumps(match)}"
                        + (" (stand-in: nearest row, not the same mode)"
                           if stand_in else ""))
    return ms, source


def budget(compute_ms: dict, fabrics: dict) -> tuple[list, list]:
    """``(rows, table lines)``: every mode at every fabric and host count
    (an intra-host fabric not for the beam-DP modes, which cross
    hosts)."""
    pay = payloads()
    lines = ["| mode | fabric | " + " | ".join(f"N={n}" for n in HOSTS)
             + " | block/deadline @N=32 |",
             "|---|---|" + "---|" * (len(HOSTS) + 1)]
    rows = []
    for mode in compute_ms:
        for fname, (alpha, bw) in fabrics.items():
            if "beam-DP" in mode and not fname.startswith("DCN"):
                continue
            effs = []
            for n in HOSTS:
                e, tn = efficiency(mode, n, alpha, bw, compute_ms, pay)
                effs.append(e)
                rows.append({"mode": mode, "fabric": fname, "hosts": n,
                             "efficiency": e, "block_s": tn,
                             "deadline_frac": tn / DEADLINE_S})
            _, t32 = efficiency(mode, 32, alpha, bw, compute_ms, pay)
            lines.append(
                f"| {mode} | {fname} | "
                + " | ".join(f"{e * 100:.1f}%" for e in effs)
                + f" | {t32 / DEADLINE_S * 100:.2f}% |")
    return rows, lines


def nvlink_fabric(nccl: dict) -> tuple[str, tuple[float, float]]:
    """The NVLink row's name and ``(alpha, bw)`` from ``--measure-nccl``'s
    report."""
    alpha, bw = nccl["alpha_s"], nccl["bw_bytes_per_s"]
    return (f"NVLink/NCCL ({bw / 1e9:.0f} GB/s, {alpha * 1e6:.1f} us; "
            f"measured, {nccl['ranks']} x {nccl['device']['kind']})",
            (alpha, bw))


def fit_alpha_beta(sizes, seconds, n: int) -> tuple[float, float]:
    """``(alpha, bw)`` of the ring model ``2(n-1)(alpha + P/n/bw)`` through
    two measured all-reduces."""
    (p1, p2), (t1, t2) = sizes, seconds
    s = (t2 - t1) / (p2 - p1)              # = 2(n-1) / (n bw)
    return (t1 - s * p1) / (2 * (n - 1)), 2 * (n - 1) / (n * s)


def nccl_rank(iters: int = 20, repeats: int = 3) -> dict | None:
    """One rank of ``--measure-nccl``: the best mean seconds of ``iters``
    all-reduces at each of ``NCCL_SIZES`` (the slowest rank's); rank 0
    returns them."""
    import torch
    import torch.distributed as dist

    from ..parallel.distributed import init_distributed, rank_device

    init_distributed("nccl")
    device = rank_device("cuda")
    torch.cuda.set_device(device)
    seconds = []
    for size in NCCL_SIZES:
        x = torch.ones(size // 4, dtype=torch.float32, device=device)
        for _ in range(3):
            dist.all_reduce(x)
        best = float("inf")
        for _ in range(repeats):
            torch.cuda.synchronize(device)
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                dist.all_reduce(x)
            torch.cuda.synchronize(device)
            t = torch.tensor([(time.perf_counter() - t0) / iters],
                             dtype=torch.float64, device=device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            best = min(best, t.item())
        seconds.append(best)
    world = dist.get_world_size()
    rank = dist.get_rank()
    dist.destroy_process_group()
    return {"ranks": world, "seconds": seconds} if rank == 0 else None


def measure_nccl(ranks: int) -> dict:
    """``--measure-nccl``: one process per card, the fit, the card."""
    from ..parallel.distributed import spawn_ranks
    from ..probes._common import card

    import torch

    outs = spawn_ranks(__spec__.name, ["--measure-nccl"], ranks, 600)
    failed = [(r, rc, e[-2000:]) for r, (rc, _, e) in enumerate(outs) if rc]
    if failed:
        raise RuntimeError(f"ranks failed: {failed}")
    got = json.loads(outs[0][1].strip().splitlines()[-1])
    alpha, bw = fit_alpha_beta(NCCL_SIZES, got["seconds"], got["ranks"])
    return {"ranks": got["ranks"], "sizes_bytes": list(NCCL_SIZES),
            "seconds": got["seconds"], "alpha_s": alpha,
            "bw_bytes_per_s": bw, "dtype": "float32",
            "model": "2(N-1)(alpha + P/N/B) through both points",
            "device": card(torch.device("cuda", 0))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paf_baseband2power_tpu_torch.tools.scaling_budget")
    ap.add_argument("--compute-json", metavar="FILE",
                    help="the bench matrix's JSON line (python -m "
                    "paf_baseband2power_tpu_torch.bench)")
    ap.add_argument("--spectra-json", metavar="FILE",
                    help="tools/spectra_bench.py's DEVICE_LAYOUT report")
    ap.add_argument("--nccl-json", metavar="FILE", default=None,
                    help="--measure-nccl's report: adds the NVLink row")
    ap.add_argument("--measure-nccl", action="store_true",
                    help="time NCCL all-reduces across the host's cards, "
                    "one process per card")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.measure_nccl:
        if args.rank is not None:
            got = nccl_rank()
            if got is not None:
                print(json.dumps(got))
            return 0
        import torch

        if not torch.cuda.is_available():
            ap.error("--measure-nccl: no CUDA device is available")
        ranks = torch.cuda.device_count()
        if ranks < 2:
            ap.error(f"--measure-nccl needs 2 or more cards, found {ranks}")
        report = measure_nccl(ranks)
        with open(NCCL_OUT, "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps(report))
        return 0

    if not (args.compute_json and args.spectra_json):
        ap.error("--compute-json and --spectra-json are required: the "
                 "budget has no built-in compute times")
    with open(args.compute_json) as f:
        matrix = json.loads(f.read().strip().splitlines()[-1])
    with open(args.spectra_json) as f:
        spectra = json.load(f)
    compute_ms, source = compute_times(matrix, spectra)
    fabrics = dict(DCN)
    nvlink = "not measured: no --nccl-json (tools/scaling_budget.py " \
             "--measure-nccl on a host of several cards)"
    if args.nccl_json:
        with open(args.nccl_json) as f:
            nccl = json.load(f)
        name, fabric = nvlink_fabric(nccl)
        fabrics[name] = fabric
        nvlink = nccl
    rows, lines = budget(compute_ms, fabrics)
    platform = "cuda" if matrix["device"]["platform"] == "gpu" else "cpu"
    report = {
        "deadline_s": DEADLINE_S,
        "model": "ring allreduce 2(N-1)(a+P/N/B); ppermute a+P/B; "
                 "eff = T1/(T1+Tcomm)",
        "compute_ms": compute_ms,
        "compute_source": source,
        "payload_bytes": payloads(),
        "fabrics": {k: {"alpha_s": a, "bw_bytes_per_s": b}
                    for k, (a, b) in fabrics.items()},
        "nvlink_nccl": nvlink,
        "device": matrix["device"],
        "rows": rows,
    }
    with open(f"scaling_budget_{platform}.json", "w") as f:
        json.dump(report, f, indent=1)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
