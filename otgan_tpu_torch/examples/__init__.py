"""Research sandboxes of the port (``python -m otgan_tpu_torch.examples.<name>``)."""
