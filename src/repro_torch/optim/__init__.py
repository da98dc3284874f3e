from repro_torch.optim.optimizer import (  # noqa: F401
    AdamWState, OptConfig, adamw_init, adamw_update, clip_by_global_norm,
    cosine_schedule, global_norm,
)
from repro_torch.optim import compression  # noqa: F401
