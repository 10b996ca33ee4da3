"""CUDA implementation of the accelerator seam (counterpart of
``deepspeed_tpu/accelerator/tpu_accelerator.py``), backed by ``torch.cuda``."""

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import Accelerator


class CudaAccelerator(Accelerator):
    _name = "cuda"

    # --- identity -------------------------------------------------------
    def device_name(self, device_index=None) -> str:
        if device_index is None:
            return self._name
        return torch.cuda.get_device_name(device_index)

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def resolve_device(self, device=None) -> torch.device:
        """``device`` as given (``"cpu"`` is how tests run the plain paths),
        else the current CUDA device. There is no silent CPU fallback."""
        if device is not None:
            device = torch.device(device)
            if device.type == "cuda" and not self.is_available():
                raise RuntimeError(f"device {device} requested but CUDA is not available")
            return device
        if not self.is_available():
            raise RuntimeError(
                "CUDA is not available: deepspeed_tpu_torch runs on an NVIDIA GPU; "
                "pass device='cpu' explicitly to run the plain PyTorch paths")
        return torch.device("cuda", torch.cuda.current_device())

    def synchronize(self, device_index=None) -> None:
        torch.cuda.synchronize(device_index)

    # --- memory ---------------------------------------------------------
    def memory_stats(self, device_index=None) -> dict:
        return dict(torch.cuda.memory_stats(device_index))

    def memory_allocated(self, device_index=None) -> int:
        return torch.cuda.memory_allocated(device_index)

    def max_memory_allocated(self, device_index=None) -> int:
        return torch.cuda.max_memory_allocated(device_index)
