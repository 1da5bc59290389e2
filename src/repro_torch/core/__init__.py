"""FalconGEMM core: scheme library, Decision Module, plan cache, dispatch."""
from . import (algorithms, autotune, backends, codegen, decision, discovery,
               engine, hardware, lcma, plan_cache)
from .backends import available_backends, get_backend, register_backend
from .engine import FalconEngine, PlannedWeight, plan_weight, use
from .falcon_gemm import FalconConfig, falcon_dense, falcon_matmul

__all__ = ["algorithms", "autotune", "backends", "codegen", "decision",
           "discovery", "engine", "hardware", "lcma", "plan_cache",
           "FalconConfig", "falcon_dense", "falcon_matmul",
           "FalconEngine", "PlannedWeight", "plan_weight", "use",
           "register_backend", "get_backend", "available_backends"]
