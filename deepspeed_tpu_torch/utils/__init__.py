def not_ported(feature: str) -> NotImplementedError:
    """The error every feature outside the port's slices raises."""
    return NotImplementedError(
        f"{feature} is not ported to deepspeed_tpu_torch yet (ROADMAP.md, Queue 1)")
