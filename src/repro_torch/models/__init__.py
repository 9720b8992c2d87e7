"""Model zoo (port of ``repro.models``): every family of the registry
(dense, audio, VLM, MoE with MLA, and the recurrent hybrid and ssm
families of ``models/recurrent.py``)."""
from . import attention, config, layers, mla, moe, transformer
from .config import ModelConfig

__all__ = ["attention", "config", "layers", "mla", "moe", "transformer",
           "ModelConfig"]
