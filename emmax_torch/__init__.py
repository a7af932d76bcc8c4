"""emmax_torch: Emma-X on PyTorch and CUDA (NVIDIA Hopper).

The port of ``emmax_tpu`` (JAX / XLA / Pallas), which stays beside it as
the reference. Public API as in ``emmax_tpu``: ``load`` (VLM) and
``load_vla`` (VLA policy). Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"


def load(*args, **kwargs):
    from emmax_torch.models.load import load as _load

    return _load(*args, **kwargs)


def load_vla(*args, **kwargs):
    from emmax_torch.models.load import load_vla as _load_vla

    return _load_vla(*args, **kwargs)


def available_models():
    from emmax_torch.models.registry import MODEL_REGISTRY

    return sorted(MODEL_REGISTRY)
