from repro_torch.optim.optimizers import (AdamState, LaneAdamState, Optimizer, adam,
                                          apply_updates, lane_adam_init, lane_adam_step)

__all__ = ["AdamState", "LaneAdamState", "Optimizer", "adam", "apply_updates",
           "lane_adam_init", "lane_adam_step"]
