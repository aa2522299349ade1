"""Serving, recovery and LM training drivers of the port."""
