"""Workload tables of the PyTorch port."""
