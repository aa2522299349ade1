"""Serving-path clock of the port."""
