from otgan_tpu_torch.eval.inception import (
    get_inception_score,
    inception_score_from_preds,
    inception_score_from_sampler,
)
from otgan_tpu_torch.eval.fid import (
    combined_eval_from_sampler,
    fid_from_sampler,
    get_fid,
)
