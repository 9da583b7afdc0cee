from repro_torch.checkpoint.checkpointer import (save, restore, latest_step,
                                                 AsyncCheckpointer)
