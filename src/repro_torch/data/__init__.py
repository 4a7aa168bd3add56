"""Synthetic data pipelines of the port (``repro.data``)."""
