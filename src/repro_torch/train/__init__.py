"""Train steps and the trainer of the port (``repro.train``)."""
