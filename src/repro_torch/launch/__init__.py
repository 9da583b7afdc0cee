"""Entry points a user runs: ``python -m repro_torch.launch.serve`` (the
serving launcher, the port's copy of ``repro/launch/serve.py``)."""
