from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, wsd_schedule,
                                         cosine_schedule)
from repro_torch.train.train_step import (TrainState, make_train_step,
                                          make_init_state)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "wsd_schedule",
           "cosine_schedule", "TrainState", "make_train_step",
           "make_init_state"]
