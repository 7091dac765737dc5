"""Data sets of the port (``repro_torch.data.synthetic``)."""
