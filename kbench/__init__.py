"""The benchmark of the PyTorch and CUDA port (kit4b_tpu_torch): one cell
at a time, `python -m kbench.run` (see README.md beside this file)."""
