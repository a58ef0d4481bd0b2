from otgan_tpu_torch.utils.metrics import MetricLogger

__all__ = ["MetricLogger"]
