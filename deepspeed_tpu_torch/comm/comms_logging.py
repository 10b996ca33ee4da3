"""Per-collective message-size accounting.

Counterpart of ``deepspeed_tpu/comm/comms_logging.py`` (reference
``deepspeed/utils/comms_logging.py``'s ``CommsLogger``). The facade's
collectives (``deepspeed_tpu_torch.comm``) call :meth:`CommsLogger.append`
once per call with the input tensor, so the counts are per execution here,
where the reference's are per compiled program.
"""

from collections import defaultdict


def get_msg_size(tensor) -> int:
    try:
        return int(tensor.numel()) * tensor.element_size()
    except AttributeError:
        return 0


def convert_size(size_bytes: float) -> str:
    if size_bytes == 0:
        return "0B"
    units = ("B", "KB", "MB", "GB", "TB")
    i = 0
    while size_bytes >= 1024 and i < len(units) - 1:
        size_bytes /= 1024.0
        i += 1
    return f"{size_bytes:.2f} {units[i]}"


class CommsLogger:
    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        # op_name -> msg_size -> count
        self.comms_dict = defaultdict(lambda: defaultdict(int))

    def append(self, op_name: str, tensor, axes):
        self.comms_dict[op_name][get_msg_size(tensor)] += 1

    def summary(self) -> dict:
        out = {}
        for op, sizes in self.comms_dict.items():
            total = sum(size * count for size, count in sizes.items())
            count = sum(sizes.values())
            out[op] = {"count": count, "total_bytes": total, "total_human": convert_size(total)}
        return out

    def totals(self) -> dict:
        """{op_name: cumulative bytes}."""
        return {op: sum(size * count for size, count in sizes.items())
                for op, sizes in self.comms_dict.items()}

    def log_all(self):
        from deepspeed_tpu_torch.utils.logging import logger

        for op, stats in self.summary().items():
            logger.info(f"comm op: {op} | calls: {stats['count']} | volume: {stats['total_human']}")
