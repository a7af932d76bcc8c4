"""Run the ``chip_smoke.py`` steps that serve from sharded params alone on
one card: the kernel checks of phase 3 (each int4 shape timed with bf16 x
and with fp32 x, the scalar kernel), the tiny config's card-vs-CPU parity
(the fp32-x int4 launches of its int4 request), and the ``multigpu``
phase's serving step on the (1, 1, 1) NCCL mesh: the bf16 request, then
the int4 tree through the speculative, paged and slot-pool engines and
``EmmaXVLA`` (``chip_smoke._mesh_int4_engines``).

    python3 scripts/chip_mesh_engines.py
"""

import json
import socket
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from emmax_torch.ops import flash_attention as fa  # noqa: E402
from emmax_torch.ops import int4_matmul  # noqa: E402
from emmax_torch.ops import paged_attention as pa  # noqa: E402
from emmax_torch.ops.cuda_build import build_all  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_mesh_engines: no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from emmax_torch.parallel import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(cs.smi_line(), flush=True)
    kernels = [fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL, int4_matmul.KERNEL]
    serving = [fa.KERNEL, int4_matmul.KERNEL, pa.KERNEL]
    print("built", build_all(kernels + [pa.KERNEL]),
          time.perf_counter() - t0, flush=True)
    dev = torch.device("cuda", 0)
    t1 = time.perf_counter()
    cs.kernel_phase(dev)
    cs.tiny_parity(dev)
    print(f"kernels and tiny wall {time.perf_counter() - t1:.3f}",
          flush=True)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = make_mesh((1, 1, 1), device_type="cuda")
        t1 = time.perf_counter()
        out = cs._mesh_serving(dev, kernels, serving, mesh)
        print(f"serving wall {time.perf_counter() - t1:.3f}", flush=True)
    finally:
        dist.destroy_process_group()
    print("multigpu serving " + json.dumps(out), flush=True)
    print(f"total {time.perf_counter() - t0:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
