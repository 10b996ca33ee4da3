"""Checkpoint conversion and inspection (counterpart of
``deepspeed_tpu/checkpoint/``; reference: ``deepspeed/checkpoint/``): the
universal interchange format, which the two packages read and write alike.
A tag of the engine already holds each leaf whole and moves between ZeRO
stages and meshes as it is."""

from deepspeed_tpu_torch.checkpoint.universal_checkpoint import (
    UniversalCheckpoint,
    ds_to_universal,
    load_universal_into_engine,
)

__all__ = ["UniversalCheckpoint", "ds_to_universal", "load_universal_into_engine"]
