"""The Hub export's self-contained ``modeling_emmax.py`` on one card: its
own kernel build and its action against the plain path.

A tiny run dir (fp32, vocab 32064, seeded) is exported with ``python -m
emmax_torch.convert_weights --mode export_hf``. Then, in processes whose
``sys.path`` holds no repository path (``import emmax_torch`` must fail):

1. the bundle on the card: ``predict_action`` through
   ``EmmaXForVision2Seq.from_pretrained(export, device="cuda")``, whose
   first flash-attention call builds ``flash_fwd.cu`` from
   ``<export>/csrc`` into ``<export>/_build`` (nvcc's seconds, the
   library's path and the bundle's launch count printed);
2. the bundle on the CPU (the plain path): the same action is required;
3. the bundle on the card in a fresh export with no ``nvcc`` reachable
   (``PATH`` without it, ``CUDA_HOME`` pointing nowhere): the call must
   raise, not give way to the plain path.

    python3 scripts/chip_standalone_bundle.py
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

BUNDLE_SCRIPT = '''
import json, sys, time
repo = {repo!r}
sys.path = [p for p in sys.path if p and p != "." and not p.startswith(repo)]
try:
    import emmax_torch
    raise SystemExit("emmax_torch importable: the check would be vacuous")
except ImportError:
    pass
sys.path.insert(0, {out!r})
import numpy as np
import torch
import modeling_emmax as M
from processing_emmax import EmmaXProcessor
model = M.EmmaXForVision2Seq.from_pretrained({out!r}, dtype=torch.float32,
                                             device={device!r})
proc = EmmaXProcessor.from_pretrained({out!r}, tokenizer=model.vla.tokenizer)
frame = np.random.default_rng(9).integers(0, 256, (256, 256, 3),
                                          dtype=np.uint8)
prompt, image = proc.get_prompt("put the carrot in the pot", frame)
t0 = time.perf_counter()
try:
    action = model.predict_action(proc(prompt, image),
                                  unnorm_key="bridge_orig")
except Exception as e:
    print("BUNDLE", json.dumps({{"raised": f"{{type(e).__name__}}: {{e}}"}}))
    raise SystemExit(0)
if {device!r} != "cpu":
    torch.cuda.synchronize()
import importlib
fa = importlib.import_module("_emmax_bundle.ops.flash_attention")
print("BUNDLE", json.dumps({{
    "action": np.asarray(action).tolist(),
    "first_call_s": time.perf_counter() - t0,
    "launches": fa.KERNEL.launches,
    "launches_by": fa.KERNEL.launches_by,
    "nvcc_s": fa.KERNEL.build_seconds,
    "library": str(fa.KERNEL.library_path()),
    "emmax_torch_loaded": "emmax_torch" in sys.modules}}))
'''


def export(root: Path) -> Path:
    import torch

    from emmax_torch import convert_weights as cw
    from emmax_torch.models.load import save_pretrained
    from emmax_torch.models.vlm import init_vlm_params, tiny_vlm_config

    generator = torch.Generator("cpu")
    generator.manual_seed(0)
    save_pretrained(root / "run", {
        "vision_backbone_id": "tiny", "llm_backbone_id": "tiny",
        "arch_specifier": "fused-gelu-mlp",
        "text_config": {"vocab_size": 32064}},
        init_vlm_params(generator, tiny_vlm_config(32064)))
    (root / "stats.json").write_text(json.dumps({"bridge_orig": {"action": {
        "q01": [-0.05] * 6 + [0.0], "q99": [0.05] * 6 + [1.0],
        "mask": [True] * 6 + [False]}}}))
    out = root / "export"
    cw.main(["--mode", "export_hf", "--src", str(root / "run"), "--dst",
             str(out), "--base_vlm", "tiny", "--export_dtype", "float32",
             "--dataset_statistics", str(root / "stats.json")])
    return out


def drive(out: Path, device: str, env=None) -> dict:
    script = out.parent / f"drive_{device}.py"
    script.write_text(BUNDLE_SCRIPT.format(repo=str(REPO), out=str(out),
                                    device=device))
    env = {k: v for k, v in (env or os.environ).items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(script)], cwd=out.parent,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"bundle on {device} failed:\n{res.stdout}\n"
                           f"{res.stderr[-4000:]}")
    line = [s for s in res.stdout.splitlines() if s.startswith("BUNDLE ")]
    return {**json.loads(line[-1].split(" ", 1)[1]),
            "process_s": time.perf_counter() - t0}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_standalone_bundle: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="emmax_bundle_"))
    try:
        out = export(tmp / "a")
        card = drive(out, "cuda")
        cpu = drive(out, "cpu")
        lib = Path(card["library"])
        checks = {
            "action_equal": card["action"] == cpu["action"],
            "built_in_export": lib.parent == out / "_build" and lib.exists(),
            "kernel_launched": card["launches"] > 0,
            "cpu_launched_none": cpu["launches"] == 0,
            "package_not_loaded": not (card["emmax_torch_loaded"]
                                       or cpu["emmax_torch_loaded"])}
        # no nvcc: a fresh export (nothing built), nvcc off PATH
        bare = export(tmp / "b")
        path = os.pathsep.join(
            d for d in os.environ.get("PATH", "").split(os.pathsep)
            if not (Path(d) / "nvcc").exists())
        no_nvcc = drive(bare, "cuda", env={**os.environ, "PATH": path,
                                           "CUDA_HOME": str(tmp / "none")})
        checks["raises_without_nvcc"] = "nvcc not found" in no_nvcc.get(
            "raised", "")
        result = {"card": card, "cpu": cpu, "no_nvcc": no_nvcc,
                  "checks": checks, "smi": smi}
        print("bundle " + json.dumps(result), flush=True)
        if not all(checks.values()):
            raise AssertionError(f"bundle checks failed: {checks}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
