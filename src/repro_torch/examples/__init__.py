"""End-to-end runs of the port, as ``python -m
repro_torch.examples.<name>`` (the reference's `examples/*.py`)."""
