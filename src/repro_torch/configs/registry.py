"""Architecture registry: --arch <id> resolution."""
from importlib import import_module

ARCHS = {
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-7b": "rwkv6_7b",
    "llama3.2-1b": "llama3_2_1b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen1.5-4b": "qwen1_5_4b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "internvl2-26b": "internvl2_26b",
    "whisper-base": "whisper_base",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
}


def _mod(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    return import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str):
    return _mod(arch).CONFIG


def get_smoke_config(arch: str):
    return _mod(arch).smoke_config()


def list_archs():
    return sorted(ARCHS)
