"""Run ``chip_smoke.py``'s ``hub`` step and ``rlds`` phase (GCOT records
from the port's own pipeline) alone on one card, then
``scripts/chip_standalone_bundle.py``: the Hub export and the GCOT path
without the rest of the smoke.

    python3 scripts/chip_hub_gcot.py
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
import chip_standalone_bundle  # noqa: E402
from emmax_torch.ops import flash_attention as fa  # noqa: E402
from emmax_torch.ops.cuda_build import build_all  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_hub_gcot: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    print(cs.smi_line(), flush=True)
    kernels = [fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL]
    print("built", build_all(kernels), time.perf_counter() - t0, flush=True)
    dev = torch.device("cuda", 0)
    for name, run in (("hub", lambda: cs.hub_step(dev, [fa.KERNEL])),
                      ("rlds", lambda: cs.rlds_phase(dev, kernels)),
                      ("bundle", chip_standalone_bundle.main)):
        t1 = time.perf_counter()
        if run() not in (None, 0) and name == "bundle":
            return 1
        print(f"{name} wall {time.perf_counter() - t1:.3f}", flush=True)
    print(f"total {time.perf_counter() - t0:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
