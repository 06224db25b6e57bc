"""IR, oracle and blocking geometry of the PyTorch port."""
