"""The benchmark of the PyTorch/CUDA port (`repro_torch`) on one H100.

`run.py` runs one cell once; `README.md` gives the layout and how a
configuration, a cell or a metric is added as files of its own.
"""
