"""Table abstraction of the PyTorch port (numpy)."""
