"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper GPUs.

The JAX package ``deepspeed_tpu`` stays the reference; this package mirrors
its module paths and never imports it (nor JAX). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from deepspeed_tpu_torch.version import __version__


def init_inference(model, config=None, params=None, device=None, seed: int = 0):
    """Reference: ``deepspeed_tpu.init_inference``. Imported on call, so
    ``import deepspeed_tpu_torch`` stays light."""
    from deepspeed_tpu_torch.inference.engine import init_inference as _init

    return _init(model, config=config, params=params, device=device, seed=seed)


__all__ = ["__version__", "init_inference"]
