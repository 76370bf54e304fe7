"""Read aligners of the port."""
