"""Activation layout hints, port of ``emmax_tpu/parallel/constraints.py``.

In the JAX package ``constrain_batch_sharded`` anchors an activation's
batch dim to the data axes, so that GSPMD does not pick a poor layout for
an intermediate. Here the collectives are explicit: every data rank
already holds exactly its own rows of every activation, and nothing
re-lays them out, so the hint has nothing to say and returns ``x``. The
call sites are kept where the JAX model has them (the towers' embedding
and output, the decoder's input), so that the two models read alike.
"""

from __future__ import annotations

from emmax_torch.parallel.sharding import DATA_AXES


def constrain_batch_sharded(x, data_axes=DATA_AXES):
    """``x`` as it is (module docstring)."""
    return x
