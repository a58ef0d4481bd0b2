from otgan_tpu_torch.nn.ema import ema_init, ema_update
from otgan_tpu_torch.nn.layers import (
    Conv2d,
    Dense,
    data_init,
    glu,
    l2_normalize_rows,
    nn_upsample,
    reset_parameters,
)
from otgan_tpu_torch.nn.optim import make_optimizer

__all__ = [
    "Conv2d",
    "Dense",
    "data_init",
    "ema_init",
    "ema_update",
    "glu",
    "l2_normalize_rows",
    "make_optimizer",
    "nn_upsample",
    "reset_parameters",
]
