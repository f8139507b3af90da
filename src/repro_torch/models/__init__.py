"""Model stacks as PyTorch modules: the dense and MoE transformer LM,
rwkv and the jamba hybrid, behind one API per family (``get_api``)."""
from .common import ModelConfig, ParamDef, init_params, param_count
from .lm import LM, build_lm
from .registry import ModelApi, get_api

__all__ = ["LM", "ModelApi", "ModelConfig", "ParamDef", "build_lm",
           "get_api", "init_params", "param_count"]
