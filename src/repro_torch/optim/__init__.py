from repro_torch.optim.optimizers import (AdamState, LaneAdamState, Optimizer, SGDState,
                                          adam, adamw, apply_updates, lane_adam_init,
                                          lane_adam_step, sgd)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine

__all__ = ["AdamState", "LaneAdamState", "Optimizer", "SGDState", "adam", "adamw",
           "apply_updates", "lane_adam_init", "lane_adam_step", "sgd", "constant",
           "cosine_decay", "warmup_cosine"]
