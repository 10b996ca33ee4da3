"""LR schedules, copied from ``deepspeed_tpu/runtime/lr_schedules.py``
(reference: ``runtime/lr_schedules.py`` — LRRangeTest :258, OneCycle :361,
WarmupLR :626, WarmupDecayLR :715). Host-side step→lr callables; the engine
reads the lr before it advances the schedule, and hands it to the optimizer
as a Python float."""

import math

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
COSINE_ANNEALING = "CosineAnnealing"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, COSINE_ANNEALING]


class _Schedule:
    """Stateful like torch schedulers: ``step()`` advances, ``get_lr()`` reads."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.last_step = 0

    def lr_at(self, step: int) -> float:
        raise NotImplementedError

    def step(self, increment: int = 1):
        self.last_step += increment

    def get_lr(self) -> float:
        return self.lr_at(self.last_step)

    def get_last_lr(self):
        return [self.get_lr()]

    def state_dict(self):
        return {"last_step": self.last_step}

    def load_state_dict(self, sd):
        self.last_step = sd["last_step"]


class WarmupLR(_Schedule):
    def __init__(self, base_lr, warmup_min_lr=0.0, warmup_max_lr=0.001, warmup_num_steps=1000, warmup_type="log"):
        super().__init__(base_lr)
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_steps = max(warmup_num_steps, 1)
        self.warmup_type = warmup_type

    def _warmup_factor(self, step):
        if step >= self.warmup_steps:
            return 1.0
        if self.warmup_type == "log":
            return math.log(step + 1) / math.log(self.warmup_steps + 1)
        return step / self.warmup_steps

    def lr_at(self, step):
        return self.min_lr + (self.max_lr - self.min_lr) * self._warmup_factor(step)


class WarmupDecayLR(WarmupLR):
    def __init__(self, base_lr, total_num_steps, warmup_min_lr=0.0, warmup_max_lr=0.001, warmup_num_steps=1000, warmup_type="log"):
        super().__init__(base_lr, warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
        self.total_num_steps = total_num_steps

    def lr_at(self, step):
        if step < self.warmup_steps:
            return super().lr_at(step)
        decay = max(0.0, (self.total_num_steps - step) / max(self.total_num_steps - self.warmup_steps, 1))
        return self.min_lr + (self.max_lr - self.min_lr) * decay


class CosineAnnealing(_Schedule):
    def __init__(self, base_lr, total_num_steps, warmup_num_steps=0, min_lr=0.0, max_lr=None):
        super().__init__(base_lr)
        self.total = total_num_steps
        self.warmup = warmup_num_steps
        self.min_lr = min_lr
        self.max_lr = max_lr if max_lr is not None else base_lr

    def lr_at(self, step):
        if self.warmup and step < self.warmup:
            return self.max_lr * step / self.warmup
        t = min(max(step - self.warmup, 0) / max(self.total - self.warmup, 1), 1.0)
        return self.min_lr + 0.5 * (self.max_lr - self.min_lr) * (1 + math.cos(math.pi * t))


class LRRangeTest(_Schedule):
    def __init__(self, base_lr, lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000, lr_range_test_step_rate=1.0, lr_range_test_staircase=False):
        super().__init__(base_lr)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def lr_at(self, step):
        interval = step // self.step_size if self.staircase else step / self.step_size
        return self.min_lr * (1 + interval * self.step_rate)


class OneCycle(_Schedule):
    def __init__(self, base_lr, cycle_min_lr, cycle_max_lr, decay_lr_rate=0.0, cycle_first_step_size=2000,
                 cycle_second_step_size=None, cycle_first_stair_count=0, cycle_second_stair_count=None,
                 decay_step_size=0, cycle_momentum=True, cycle_min_mom=0.85, cycle_max_mom=0.99, decay_mom_rate=0.0):
        super().__init__(base_lr)
        self.min_lr = cycle_min_lr
        self.max_lr = cycle_max_lr
        self.first = cycle_first_step_size
        self.second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
        self.decay_rate = decay_lr_rate
        self.decay_step_size = max(decay_step_size, 1)
        self.cycle_momentum = cycle_momentum
        self.min_mom = cycle_min_mom
        self.max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def lr_at(self, step):
        total_cycle = self.first + self.second
        if step <= self.first:
            frac = step / self.first
            return self.min_lr + (self.max_lr - self.min_lr) * frac
        if step <= total_cycle:
            frac = (step - self.first) / self.second
            return self.max_lr - (self.max_lr - self.min_lr) * frac
        decay_steps = (step - total_cycle) / self.decay_step_size
        return self.min_lr / (1 + self.decay_rate * decay_steps)

    def mom_at(self, step):
        if not self.cycle_momentum:
            return self.max_mom
        if step <= self.first:
            return self.max_mom - (self.max_mom - self.min_mom) * (step / self.first)
        total = self.first + self.second
        if step <= total:
            return self.min_mom + (self.max_mom - self.min_mom) * ((step - self.first) / self.second)
        return self.max_mom


SCHEDULE_REGISTRY = {
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
    ONE_CYCLE: OneCycle,
    LR_RANGE_TEST: LRRangeTest,
    COSINE_ANNEALING: CosineAnnealing,
}


def create_lr_scheduler(scheduler_config, base_lr: float):
    if scheduler_config is None or scheduler_config.type is None:
        return None
    cls = SCHEDULE_REGISTRY.get(scheduler_config.type)
    if cls is None:
        raise ValueError(f"Unknown scheduler type {scheduler_config.type}; valid: {list(SCHEDULE_REGISTRY)}")
    return cls(base_lr, **scheduler_config.params)
