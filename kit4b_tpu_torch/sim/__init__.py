"""The read simulator of the port (a copy of kit4b_tpu/sim)."""
