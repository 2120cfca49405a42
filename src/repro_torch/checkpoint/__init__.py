from .ckpt import latest_step, list_steps, restore, save
