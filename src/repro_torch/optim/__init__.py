from repro_torch.optim.optimizers import (AdamState, LaneAdamState, Optimizer, SGDState,
                                          adam, adamw, apply_updates, lane_adam_init,
                                          lane_adam_step, sgd)

__all__ = ["AdamState", "LaneAdamState", "Optimizer", "SGDState", "adam", "adamw",
           "apply_updates", "lane_adam_init", "lane_adam_step", "sgd"]
