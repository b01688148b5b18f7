"""Run one cell of the benchmark once, on the cards of this machine.

    python3 -m qoabench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints a few lines on standard error, each number ``correct`` compares
beside its limit as its last lines there, and one JSON line as the last
line of standard output.  With ``--trace 0`` the line's metrics are the
cell's end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and the metrics are the cell's per-layer metrics.
Exits with 2, printing no result, where CUDA has fewer cards than the cell
needs, and with 3 where the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(ROOT, "build", "qoabench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"), ("PYTORCH_KERNEL_CACHE_PATH", "kernels")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()

    import torch

    from qoabench import guard, harness, spec

    cell = spec.load(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), devices, T_START)
    bad = guard.forbidden_modules()
    if bad:
        print(f"the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
