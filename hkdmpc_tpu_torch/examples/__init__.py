"""Runnable examples of the PyTorch port (`python -m
hkdmpc_tpu_torch.examples.<name>`): the closed-loop single-robot MPC and the
closed-loop fleet MPC. Each keeps its loop (a function that `chip_smoke.py`
and the tests call) apart from its command line and its plot."""
