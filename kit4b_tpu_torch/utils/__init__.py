"""Run logging, phase timers and the summaries DB of the port (copies of kit4b_tpu/utils)."""
