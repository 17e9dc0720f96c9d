"""Run one cell of BENCHMARK.json once, on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), device (and with --trace 1 a
breakdown of the traced window), and last `compared`: each number compared
with the plain reference beside its limit, which also end standard error.
Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 2; if JAX or the JAX package is loaded once the window
has closed, it exits 3.
"""

import time

T0 = time.perf_counter()  # process start, as near as Python lets the benchmark read it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vaeplay_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().replace("\n", "; ")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark.core.manifest import ROOT, find_cell

    cell = find_cell(args.workload)
    cache = ROOT / ".bench_cache"  # fixed, inside the checkout: found again by every later run
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    from benchmark.harness import run_cell

    seed = args.seed % (2 ** 63)
    result, lines = run_cell(cell, seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}; the benchmark runs without JAX and the "
              f"JAX package", file=sys.stderr)
        return 3
    print(f"[card] {power_limit()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
