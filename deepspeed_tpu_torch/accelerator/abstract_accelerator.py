"""Hardware abstraction seam (counterpart of
``deepspeed_tpu/accelerator/abstract_accelerator.py``), cut to what the
serving slice uses: device identity, device resolution, synchronisation and
memory stats."""

import abc


class Accelerator(abc.ABC):
    _name: str = "abstract"

    # --- identity -------------------------------------------------------
    def device_name(self, device_index=None) -> str:
        raise NotImplementedError

    def is_available(self) -> bool:
        raise NotImplementedError

    @abc.abstractmethod
    def device_count(self) -> int:
        """Devices visible to this process."""

    def resolve_device(self, device=None):
        """The ``torch.device`` an entry point runs on: the accelerator
        unless the caller names another device; raises when the accelerator
        is absent and nothing else was asked for."""
        raise NotImplementedError

    def synchronize(self, device_index=None) -> None:
        raise NotImplementedError

    # --- memory ---------------------------------------------------------
    def memory_stats(self, device_index=None) -> dict:
        raise NotImplementedError

    def memory_allocated(self, device_index=None) -> int:
        raise NotImplementedError

    def max_memory_allocated(self, device_index=None) -> int:
        raise NotImplementedError
