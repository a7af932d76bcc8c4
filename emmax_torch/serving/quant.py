"""Weight-only quantization for serving, port of ``emmax_tpu/serving/quant.py``.

The decoder's matmul weights and the lm_head are quantized: int8
per-output-channel (``{"q8", "scale"}``) or nibble-packed group-wise int4
(``{"q4", "scale"}``, ``ops/int4_matmul``). The embedding table is
gathered, not streamed, and stays as it is; so do the norms. Quantization
runs on the tensors' own device, one layer at a time for int4, so a 7B
tree quantizes on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from emmax_torch.ops.int4_matmul import DEFAULT_GROUP, quantize_weight_int4

# llama-family matmul weights; biases and norms are never quantized
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] -> {"q8": int8, "scale": f32 [..., 1, out]}."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q8": q, "scale": scale}


def weight_quantizer(bits: int, group: int = DEFAULT_GROUP) -> Callable:
    """The quantizer of one weight: int8 per-channel or int4 group-wise."""
    if bits == 8:
        return quantize_weight
    if bits == 4:
        return lambda w: quantize_weight_int4(w, group=group)
    raise ValueError(f"bits must be 4 or 8, got {bits}")


def quantize_vlm_params(params: Dict[str, Any], bits: int = 8,
                        group: Optional[int] = None) -> Dict[str, Any]:
    """The VLM tree with its decoder's matmul weights and lm_head quantized
    (``bits`` 8 or 4; ``group``, int4 only, defaults to ``DEFAULT_GROUP``).
    A new tree is returned; the input's dense leaves are freed once the
    caller drops it."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if group is not None and bits != 4:
        raise ValueError("group is only meaningful for bits=4")
    qfn = weight_quantizer(bits, DEFAULT_GROUP if group is None else group)
    llm = dict(params["llm"])
    layers = dict(llm["layers"])
    for key in QUANT_KEYS:
        if key in layers and not isinstance(layers[key], dict):
            layers[key] = qfn(layers[key])
    llm["layers"] = layers
    if not isinstance(llm["lm_head"], dict):
        llm["lm_head"] = qfn(llm["lm_head"])
    return {**params, "llm": llm}
