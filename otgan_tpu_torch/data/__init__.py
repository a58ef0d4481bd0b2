from otgan_tpu_torch.data.cifar10 import DataLoader, load, random_flip, synthetic
from otgan_tpu_torch.data.toy import GAUSSIAN_CENTERS, mode_coverage, sample_8gaussians

__all__ = ["DataLoader", "GAUSSIAN_CENTERS", "load", "mode_coverage", "random_flip",
           "sample_8gaussians", "synthetic"]
