"""End-to-end drivers of the port (``python -m repro_torch.examples.train_100m``)."""
