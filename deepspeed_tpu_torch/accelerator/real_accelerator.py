"""Accelerator selection (counterpart of
``deepspeed_tpu/accelerator/real_accelerator.py``)."""

_accelerator = None


def get_accelerator():
    global _accelerator
    if _accelerator is None:
        from deepspeed_tpu_torch.accelerator.cuda_accelerator import CudaAccelerator

        _accelerator = CudaAccelerator()
    return _accelerator


def set_accelerator(accel) -> None:
    """Inject another accelerator implementation (before the first
    get_accelerator() call to take effect everywhere)."""
    global _accelerator
    _accelerator = accel
