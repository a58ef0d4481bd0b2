from otgan_tpu_torch.ops.costs import cosine_cost, scaled_sqeuclidean_cost
from otgan_tpu_torch.ops.losses import med_discriminator_loss, med_generator_loss
from otgan_tpu_torch.ops.matching import (
    MatchedFeatures,
    calc_distance,
    calc_distance_mean,
    match_random,
    match_single_batch,
    match_two_batch,
)
from otgan_tpu_torch.ops.sinkhorn import sinkhorn_assignment, sinkhorn_log

__all__ = [
    "MatchedFeatures",
    "calc_distance",
    "calc_distance_mean",
    "cosine_cost",
    "match_random",
    "match_single_batch",
    "match_two_batch",
    "med_discriminator_loss",
    "med_generator_loss",
    "scaled_sqeuclidean_cost",
    "sinkhorn_assignment",
    "sinkhorn_log",
]
