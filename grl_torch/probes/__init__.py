"""Measurement entry points of the port (``python -m grl_torch.probes.<name>``)."""
