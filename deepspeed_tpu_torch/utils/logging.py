"""Rank-filtered logging (counterpart of ``deepspeed_tpu/utils/logging.py``).

The rank is the ``torch.distributed`` rank when a process group is
initialised, else 0.
"""

import functools
import logging
import os
import sys

LOG_LEVEL = os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper()

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


@functools.lru_cache(None)
def _create_logger(name: str, level: str) -> logging.Logger:
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger_.addHandler(handler)
    return logger_


logger = _create_logger("deepspeed_tpu_torch", LOG_LEVEL)


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks=None, level=logging.INFO) -> None:
    """Log ``message`` only on the listed ranks (None/-1 = all)."""
    my_rank = _process_index()
    if ranks is None or any(r == -1 or r == my_rank for r in ranks):
        logger.log(level, f"[Rank {my_rank}] {message}")

