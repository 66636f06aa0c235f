"""CLI: rebuild the native libraries (the reference's ``rebuild.py``).

``python -m paf_baseband2power_tpu_torch.cli.rebuild [--debug] [--tsan]
[--asan] [--host-only] [--build-dir DIR]`` removes the libraries of the
build directory (default the package's git-ignored ``.build/``) and builds
them again through ``ops/_build.py``: the CUDA kernels' library with
``nvcc`` (unless ``--host-only``) and the host library (ring buffer,
capture engine, sender) with ``g++``. The flags add the JAX package's
host variants, each under the hash of its own flags: ``--debug`` (``-O0
-DPAFB2P_DEBUG``), ``--tsan`` (``-fsanitize=thread``) and ``--asan``
(``-fsanitize=address``). Load a variant with ``PAFB2P_NATIVE_LIB=<path>``
(and the sanitizer's runtime in ``LD_PRELOAD``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import glob
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pafb2p_rebuild")
    ap.add_argument("--debug", action="store_true",
                    help="also build the host library with -DPAFB2P_DEBUG "
                    "-O0")
    ap.add_argument("--tsan", action="store_true")
    ap.add_argument("--asan", action="store_true")
    ap.add_argument("--host-only", action="store_true",
                    help="build the host library only (no nvcc needed)")
    ap.add_argument("--build-dir", default=None,
                    help="build directory (default: the package's .build/)")
    args = ap.parse_args(argv)

    from ..io import ringbuffer as rb
    from ..ops import _build

    build_dir = args.build_dir or _build.BUILD_DIR
    stems = ["libpafb2p-", "libpafb2p."] + (
        [] if args.host_only else ["libpafb2p_cuda-"])
    for stem in stems:
        for path in glob.glob(os.path.join(build_dir, stem + "*")):
            os.remove(path)
    variants = [""] + [v for v in ("debug", "tsan", "asan")
                       if getattr(args, v)]
    jobs = [functools.partial(rb.build_native, v, build_dir)
            for v in variants]
    if not args.host_only:
        jobs.insert(0, functools.partial(_build.build, build_dir=build_dir))
    # every library at once, each compiler a process of its own
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(job) for job in jobs]
    try:
        built = [f.result() for f in futures]
    except RuntimeError as e:
        print(f"rebuild failed: {e}", file=sys.stderr)
        return 1
    for path in built:
        print(path)
    print("native rebuild complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
