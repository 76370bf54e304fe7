"""FASTA/FASTQ I/O and SAM flags of the port (copies of kit4b_tpu/io)."""
