"""The FalconGEMM public API — ``import repro_torch.api as falcon``.

    import repro_torch.api as falcon

    with falcon.use(falcon.FalconConfig(mode="strassen")):
        y = falcon.dense(x, w)                       # context config
        s = falcon.einsum("bqhd,bkhd->bhqk", q, k)   # hits the Decision Module

    pw = falcon.plan_weight(w, m_hint=batch * prompt_len)   # offline Combine B
    y = falcon.dense(x, pw)                                 # serving fast path

    with falcon.use(falcon.FalconConfig(quantize=True)):    # the int8 tier
        pw = falcon.plan_weight(w, m_hint=256)   # also bakes int8 B̃q + scales
        y = falcon.dense(x, pw)                  # int8 where the decision says

    eng = falcon.FalconEngine(falcon.FalconConfig(mode="gemm"))  # a pinned config
    y = eng.dense(x, w)

    w.requires_grad_()                   # training: a planned backward
    falcon.dense(x, w).sum().backward()  # dA, dB planned like the forward

Compatibility forms (``falcon_matmul(a, b, cfg)`` / ``falcon_dense(x, w,
cfg)`` with an explicit config) keep working.
"""
from __future__ import annotations

from repro_torch.core.backends import (Backend, available_backends, get_backend,
                                       register_backend, unregister_backend)
from repro_torch.core.decision import backward_shapes
from repro_torch.core.engine import (FalconEngine, PlannedWeight, active_config,
                                     current_config, dense, dot_general, einsum,
                                     grouped_expert_shapes, grouped_matmul, matmul,
                                     plan_weight, precombine_params, projection_shapes,
                                     refresh_planned_params, use, warm_buckets)
from repro_torch.core.falcon_gemm import (FalconConfig, falcon_dense, falcon_matmul,
                                          grouped_matmul_with_precombined,
                                          matmul_with_precombined, plan, plan_batched,
                                          plan_sharded, plan_training, precombine_weights)
from repro_torch.core.workloads import (Contraction, ContractionSpec, contraction_set,
                                        dense_projection_shapes, grouped_moe_shapes,
                                        resolve_contractions)

# The reference's names.
__all__ = [
    # context-scoped config
    "use", "current_config", "active_config", "FalconConfig", "FalconEngine",
    # dispatch entry points
    "dense", "matmul", "dot_general", "einsum", "plan", "plan_sharded",
    # grouped batched dispatch (group-parallel execution)
    "grouped_matmul", "plan_batched", "grouped_expert_shapes",
    "grouped_matmul_with_precombined",
    # planned training (autograd cores over the planned dispatch)
    "plan_training", "backward_shapes", "refresh_planned_params",
    # precombined weights (offline Combine B)
    "PlannedWeight", "plan_weight", "precombine_params",
    "precombine_weights", "matmul_with_precombined",
    # workload registry (config -> contraction set -> warm plan)
    "ContractionSpec", "Contraction", "contraction_set",
    "resolve_contractions", "dense_projection_shapes", "grouped_moe_shapes",
    # bucket pre-planning (continuous-batching serve path)
    "warm_buckets", "projection_shapes",
    # backend registry
    "Backend", "register_backend", "unregister_backend", "get_backend",
    "available_backends",
    # compatibility forms
    "falcon_matmul", "falcon_dense",
]
