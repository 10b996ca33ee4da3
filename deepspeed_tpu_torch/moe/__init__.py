from deepspeed_tpu_torch.moe.layer import MLPExpert, MoE
from deepspeed_tpu_torch.moe.sharded_moe import (
    GateOutput,
    MoEGroups,
    compute_capacity,
    moe_forward,
    top1_gating,
    top2_gating,
    topk_gating,
)
