"""Model zoo (port of ``repro.models``): the decoder families that serving
needs (dense, audio, VLM, MoE with MLA). The recurrent families
(``models/recurrent.py``) are not ported yet (ROADMAP Queue 1)."""
from . import attention, config, layers, mla, moe, transformer
from .config import ModelConfig

__all__ = ["attention", "config", "layers", "mla", "moe", "transformer",
           "ModelConfig"]
