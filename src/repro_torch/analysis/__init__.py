"""Hardware descriptions for the PyTorch port."""
