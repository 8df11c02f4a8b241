"""Entry points of the port (counterpart of `repro.launch`): the serving
launcher, `python -m repro_torch.launch.serve`."""
