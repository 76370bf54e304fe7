"""The kalign device passes in plain PyTorch (ported from kit4b_tpu/ops)."""
