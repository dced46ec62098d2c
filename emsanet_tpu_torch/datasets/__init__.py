"""Dataset metadata of the port."""
