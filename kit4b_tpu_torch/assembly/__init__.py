"""Read filtering, de novo assembly and scaffolding of the port."""
