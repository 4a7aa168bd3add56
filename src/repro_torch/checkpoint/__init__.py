"""Checkpointing of the port (``repro.checkpoint``)."""
