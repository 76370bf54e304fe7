"""K-mer engines of the port."""
