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
"""
from __future__ import annotations

from repro_torch.core.backends import (Backend, available_backends, get_backend,
                                       register_backend, unregister_backend)
from repro_torch.core.engine import (PlannedWeight, active_config,
                                     current_config, dense, dot_general, einsum,
                                     grouped_matmul, matmul, plan_weight,
                                     precombine_params, use)
from repro_torch.core.falcon_gemm import (FalconConfig, matmul_with_precombined,
                                          plan, plan_batched, precombine_weights)

__all__ = [
    "use", "current_config", "active_config", "FalconConfig",
    "dense", "matmul", "dot_general", "einsum", "plan",
    "grouped_matmul", "plan_batched",
    "PlannedWeight", "plan_weight", "precombine_params",
    "precombine_weights", "matmul_with_precombined",
    "Backend", "register_backend", "unregister_backend", "get_backend",
    "available_backends",
]
