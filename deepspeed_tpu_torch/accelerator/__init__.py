from deepspeed_tpu_torch.accelerator.abstract_accelerator import Accelerator  # noqa: F401
from deepspeed_tpu_torch.accelerator.real_accelerator import get_accelerator, set_accelerator  # noqa: F401
