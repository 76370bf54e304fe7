"""The host index build of the port (copies of kit4b_tpu/index)."""
