"""Launchers of the port: the stencil serving front (``stencil_serve``)."""
