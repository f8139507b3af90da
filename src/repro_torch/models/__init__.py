"""Model stacks as PyTorch modules: the dense and MoE transformer LM,
rwkv and the jamba hybrid, behind one API per family (``get_api``),
and the logical-axis rules engine that shards them on a mesh."""
from .common import (ModelConfig, ParamDef, PartitionSpec, init_params,
                     make_rules, param_count, param_placements, param_pspecs,
                     placements_for, spec_for)
from .lm import LM, build_lm
from .registry import ModelApi, get_api

__all__ = ["LM", "ModelApi", "ModelConfig", "ParamDef", "PartitionSpec",
           "build_lm", "get_api", "init_params", "make_rules", "param_count",
           "param_placements", "param_pspecs", "placements_for", "spec_for"]
