"""Training: AdamW and the train step (port of ``repro.train``)."""
from repro_torch.train.optimizer import (AdamW, AdamWState, constant_lr,
                                         global_norm, warmup_cosine)
from repro_torch.train.train_step import (TrainState, bind_state, init_state,
                                          make_train_step, state_specs)

__all__ = ["AdamW", "AdamWState", "constant_lr", "global_norm",
           "warmup_cosine", "TrainState", "bind_state", "init_state",
           "make_train_step", "state_specs"]
