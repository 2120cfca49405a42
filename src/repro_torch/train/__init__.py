"""Training: AdamW and its schedule (``optimizer``) and the train step
and loop with checkpointed resume (``loop``); counterpart of
``repro/train``."""
from .optimizer import (AdamWState, adamw_init, adamw_update,
                        clip_by_global_norm, warmup_cosine)
from .loop import TrainState, make_train_step, train_loop
