"""The model zoo's attention families in PyTorch (the port of
``repro.models``): dense, vlm and the MoE model without MLA. See
``model.py`` for what is not ported yet."""
from .from_reference import params_from_reference
from .model import LM, EncDecLM, build_model, count_params_struct

__all__ = ["LM", "EncDecLM", "build_model", "count_params_struct", "params_from_reference"]
