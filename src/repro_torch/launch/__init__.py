"""Drivers: `python -m repro_torch.launch.{train,serve,reshard} --help`."""
