"""Continuous-batching serve engine with bucketed plan reuse.

``ServeEngine`` admits requests into a fixed slot set through power-of-two
shape buckets so every step runs a pre-planned FalconGEMM shape, and on the
card replays each bucket's step as one captured CUDA graph.
"""
from .buckets import BucketPolicy, next_pow2
from .engine import ServeEngine, StepLoop
from .prefix_cache import PrefixEntry, RadixPrefixCache
from .request import Request, RequestQueue
from .scheduler import DecodeWork, PrefillWork, Scheduler
from .speculative import DraftModel, SelfDraft
from .stats import ServeStats
from .step_graphs import Step, StepGraphs

__all__ = ["BucketPolicy", "next_pow2", "ServeEngine", "StepLoop", "Request",
           "RequestQueue", "DecodeWork", "PrefillWork", "Scheduler",
           "ServeStats", "DraftModel", "SelfDraft", "RadixPrefixCache",
           "PrefixEntry", "Step", "StepGraphs"]
