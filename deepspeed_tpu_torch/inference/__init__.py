from deepspeed_tpu_torch.inference.continuous import ContinuousBatchingEngine
from deepspeed_tpu_torch.inference.engine import InferenceEngine, init_inference

__all__ = ["ContinuousBatchingEngine", "InferenceEngine", "init_inference"]
