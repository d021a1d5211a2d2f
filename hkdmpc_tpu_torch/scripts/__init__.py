"""Command-line tools of the PyTorch port (`python -m
hkdmpc_tpu_torch.scripts.<name>`): the TOWR trajectory recorder and the
replay viewer, both on the port's LCM transport and codec."""
