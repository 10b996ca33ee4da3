"""Pluggable checkpoint engine seam (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``; reference:
``runtime/checkpoint_engine/checkpoint_engine.py`` CheckpointEngine ABC)."""

import abc


class CheckpointEngine(abc.ABC):
    @abc.abstractmethod
    def save(self, path: str, state_tree, metadata: dict) -> None:
        ...

    @abc.abstractmethod
    def load(self, path: str, template_tree):
        """Returns (restored_tree, metadata). ``template_tree`` supplies the
        target keys, devices and dtypes: a restored leaf lands on its
        template's device, in its template's dtype."""
        ...

    def commit(self, tag: str) -> bool:
        return True
