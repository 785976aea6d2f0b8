"""Optimizers and learning-rate schedules of the port (`repro.optim`)."""
from repro_torch.optim.optimizers import (adamw_apply, adamw_apply_zero1,
                                          adamw_init,
                                          adamw_update, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          sgd_init, sgd_update)
from repro_torch.optim.schedule import constant_schedule, cosine_schedule
