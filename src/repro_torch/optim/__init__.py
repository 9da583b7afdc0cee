from repro_torch.optim.optimizers import (OptConfig, init_opt_state,
                                          apply_updates, apply_updates_,
                                          global_norm)
from repro_torch.optim.schedules import warmup_cosine, step_decay, constant
