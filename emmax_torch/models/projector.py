"""Vision -> LLM projectors, port of ``emmax_tpu/models/projector.py``.

The Emma-X flagship uses ``fused-gelu-mlp``: fused_dim -> 4 * fused_dim ->
llm_dim -> llm_dim with exact GELU between layers. f32 tower features
against bf16 weights compute in f32, as in JAX.

Under a ``mesh`` the kernels are this rank's blocks. A layer whose kernel
is split on ``tensor`` by columns (``parallel.tensor.column_split``; the
JAX package's rules place every projector kernel so) computes the rank's
columns, with its slice of the replicated bias and the GELU on them, and
the ranks' columns are then put together; any other layer gathers its
kernel where it is used.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from emmax_torch.models.tree import ParamTree
from emmax_torch.models.vit import linear
from emmax_torch.parallel.tensor import column_split

Params = Dict[str, Any]


def projector_dims(arch_specifier: str, vision_dim: int, llm_dim: int):
    kind = arch_specifier.split("+")[-1]
    if kind == "linear":
        return [(vision_dim, llm_dim)]
    if kind == "gelu-mlp":
        return [(vision_dim, llm_dim), (llm_dim, llm_dim)]
    if kind == "fused-gelu-mlp":
        return [(vision_dim, 4 * vision_dim), (4 * vision_dim, llm_dim),
                (llm_dim, llm_dim)]
    raise ValueError(f"unsupported projector arch {arch_specifier!r}")


def init_projector_params(generator: torch.Generator, arch_specifier: str,
                          vision_dim: int, llm_dim: int,
                          dtype: torch.dtype = torch.float32,
                          device="cpu") -> Params:
    """torch nn.Linear's default init: U(-1/sqrt(in), 1/sqrt(in))."""
    layers = []
    for d_in, d_out in projector_dims(arch_specifier, vision_dim, llm_dim):
        bound = d_in ** -0.5
        layers.append({
            "kernel": torch.empty((d_in, d_out), dtype=dtype,
                                  device=device).uniform_(
                -bound, bound, generator=generator),
            "bias": torch.zeros((d_out,), dtype=dtype, device=device),
        })
    return {"layers": layers}


def projector_forward(params: Params, x: torch.Tensor,
                      mesh=None) -> torch.Tensor:
    """``mesh``: the kernels are this rank's blocks (module docstring)."""
    layers = params["layers"]
    for i, layer in enumerate(layers):
        split = column_split(layer["kernel"], mesh)
        x = linear(split.enter(x), split.weight(layer["kernel"]),
                   split.cols(layer["bias"]))
        if i + 1 < len(layers):
            x = F.gelu(x)
        x = split.gather(x)
    return x


class Projector(nn.Module):
    def __init__(self, params: Params) -> None:
        super().__init__()
        self.params = ParamTree(params)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return projector_forward(self.params.tree(), x)
