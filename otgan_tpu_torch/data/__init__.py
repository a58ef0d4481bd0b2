from otgan_tpu_torch.data.cifar10 import DataLoader, load, random_flip, synthetic

__all__ = ["DataLoader", "load", "random_flip", "synthetic"]
