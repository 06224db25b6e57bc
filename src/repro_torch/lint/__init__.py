"""Stable diagnostic codes of the PyTorch port's front door."""
