"""Train steps and the trainer of the port (``repro.train``);
``CapturedTrainStep`` is the one-device step captured in one CUDA graph,
as the ``Trainer`` runs it on the card."""
from .captured import CapturedTrainStep

__all__ = ["CapturedTrainStep"]
