"""SAM flag bits the port's SAM writer sets (the values of
kit4b_tpu/io/sam.py)."""
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
