"""Config module for --arch qwen3-1.7b (see registry.py for the exact figures and source tag)."""

from repro_torch.configs.registry import qwen3_1p7b as config

CONFIG = config()
