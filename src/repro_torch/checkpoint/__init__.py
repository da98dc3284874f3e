from repro_torch.checkpoint.checkpointing import (  # noqa: F401
    all_steps, latest_step, restore, save,
)
