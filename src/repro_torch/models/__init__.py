"""The model zoo in PyTorch (the port of ``repro.models``): the dense, vlm
and MoE attention families, MLA (DeepSeek-V2), the Mamba/attention hybrid
(Jamba), RWKV-6 and the Whisper encoder-decoder."""
from .from_reference import params_from_reference
from .model import LM, EncDecLM, build_model, count_params_struct, reset_caches

__all__ = ["LM", "EncDecLM", "build_model", "count_params_struct", "params_from_reference",
           "reset_caches"]
