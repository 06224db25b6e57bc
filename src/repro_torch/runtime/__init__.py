"""Serving step builders of the port (``trainer``); training, fault
tolerance and the pipeline runtime come with later slices."""
