"""Clocks per mma.sync m16n8k8 TF32 instruction on one SM sub-partition of the
card, for the operand patterns of the port's attention kernel
(vaeplay_torch/ops/csrc/flash_attention.cu; see mma_rate.cu). A measuring
tool, not part of the port. Needs a CUDA device and nvcc; from the repo root:

    python3 -m tools_torch.mma_rate

At the data-sheet TF32 peak (495 TFLOP/s dense on an H100 SXM, 528
sub-partitions at about 1.8 GHz) one instruction, 2 * 16 * 8 * 8 FLOP, would
take about 4 clocks.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from vaeplay_torch.ops import _build

HERE = Path(__file__).resolve().parent
MODES = {0: ("instruction alone, registers", 1), 1: ("3xTF32, registers", 3),
         2: ("3xTF32, B loaded from shared memory and split, as the kernel's score loop", 3),
         3: ("3xTF32, B pre-split in shared memory, one 16-byte load", 3)}
NACC, KSTEPS, ITERS = 15, 4, 200


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 1
    _build.build(["mma_rate"], csrc=HERE)
    lib = ctypes.CDLL(str(_build.library_path("mma_rate", HERE)))
    lib.mma_rate.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    for mode, (what, per_tile) in MODES.items():
        for threads in (256, 384):
            out = torch.empty(blocks * threads, device="cuda")
            cycles = torch.zeros(blocks, dtype=torch.int64, device="cuda")
            err = lib.mma_rate(out.data_ptr(), cycles.data_ptr(), blocks, threads, ITERS, mode)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"mma_rate mode {mode}: CUDA error {err}")
            per_subpartition = threads // 32 // 4 * ITERS * KSTEPS * NACC * per_tile
            clk = float(cycles.double().mean()) / per_subpartition
            print(f"mode {mode}, {threads // 32} warps: {clk:.2f} clocks per mma.sync "
                  f"per sub-partition ({what}) on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
