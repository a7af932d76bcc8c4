"""Run ``chip_smoke.py``'s ``rlds`` phase alone on one card: build the
three flash-attention kernels the train step launches, then drive
``chip_smoke.rlds_phase`` (the GCOT and RLDS loops at vla-train's cut,
the frame store, determinism) and print its ``rlds {...}`` line.

    python3 scripts/chip_rlds_phase.py
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from emmax_torch.ops import flash_attention as fa  # noqa: E402
from emmax_torch.ops.cuda_build import build_all  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_rlds_phase: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    print(cs.smi_line(), flush=True)
    kernels = [fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL]
    print("built", build_all(kernels), time.perf_counter() - t0, flush=True)
    cs.rlds_phase(torch.device("cuda", 0), kernels)
    print("total", time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
