"""The int4 matmul alone on one card: ``chip_smoke.check_int4`` at
Emma-X's four weight shapes and the seven M the paths give it (fp32 x,
and bf16 x beside it), each held to its plain version and timed, and the
int4 kernels' registers, spills and shared memory from ``-Xptxas -v``.

    python3 scripts/chip_int4_fp32.py

It imports ``chip_smoke`` and ``emmax_torch`` from the checkout that holds
it, so a copy of the script placed in an older checkout times that tree.
One ``int4 {...}`` line per shape, then a summary line of the times.
"""

import json
import sys
import time
from pathlib import Path


def main() -> int:
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_int4_fp32: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from emmax_torch.models.vlm import emma_x_vlm_config
    from emmax_torch.ops import int4_matmul
    from emmax_torch.ops.cuda_build import build_all
    from emmax_torch.vla.tokenizer import load_tokenizer

    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"{root}; {cs.smi_line()}", flush=True)
    print("built", build_all([int4_matmul.KERNEL]),
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if hasattr(cs, "int4_resources"):
        print("int4_matmul resources "
              + json.dumps(cs.int4_resources(int4_matmul.KERNEL)), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    cfg = emma_x_vlm_config()
    _, _, Lq, _ = cs.prefill_shape(load_tokenizer(None), cfg.num_patches)
    llm = cfg.llm
    D, Fh, V = llm.dim, llm.hidden_dim, llm.vocab_size
    summary = {}
    for M in (1, 6, cs.SPEC_W_LINEAR, cs.TAIL, cs.SPEC_W_TREE, 48, Lq):
        for n, d, f in (("wq/wk/wv/wo", D, D), ("w_gate/w_up", D, Fh),
                        ("w_down", Fh, D), ("lm_head", D, V)):
            rec = cs.check_int4(dev, gen, f"{n} M{M} D{d} F{f}", M, d, f)
            print("int4 " + json.dumps(rec), flush=True)
            summary[rec["shape"]] = {"fp32_ms": rec["fp32"]["ms"],
                                     "bf16_ms": rec["ms"]}
    print(f"summary {root} " + json.dumps(summary), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
