"""FalconGEMM core: scheme library, Decision Module, plan cache, dispatch."""
from . import algorithms, backends, decision, engine, hardware, lcma, plan_cache
from .backends import available_backends, get_backend, register_backend
from .engine import PlannedWeight, plan_weight, use
from .falcon_gemm import FalconConfig

__all__ = ["algorithms", "backends", "decision", "engine", "hardware", "lcma",
           "plan_cache", "FalconConfig", "PlannedWeight", "plan_weight", "use",
           "register_backend", "get_backend", "available_backends"]
