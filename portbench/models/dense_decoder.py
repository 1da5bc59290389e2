"""The port's side of a dense decoder configuration: the port's
``ModelConfig`` built from the configuration file, as the file states it.

The file's keys are the published ``config.json``'s; ``spec`` is the file as
run (``reference.dense_decoder.as_run``: its ``run_as`` values laid over
them). Every key the port has a setting for is passed to it (norm epsilon,
rotary base, tied embeddings, dtype); a key the port has no setting for must
hold, as run, the value the port runs (the scalar multipliers at their
neutral values), else the configuration cannot be run and this raises.
"""
from __future__ import annotations

from portbench.reference.dense_decoder import dims

__all__ = ["port_config"]


def port_config(spec: dict):
    """``repro_torch``'s ModelConfig for the configuration file ``spec``."""
    from repro_torch.configs.base import ModelConfig

    z = dims(spec)
    neutral = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
               "logits_scaling": 1.0, "attention_multiplier": z["head_dim"] ** -0.5}
    for key, value in neutral.items():
        if float(spec.get(key, value)) != value:
            raise ValueError(f"{spec['name']}: {key}={spec[key]}: the port's dense decoder "
                             f"runs {value} and has no setting for it")
    if spec.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{spec['name']}: hidden_act={spec['hidden_act']}: the port's "
                         "SwiGLU runs silu")
    return ModelConfig(
        name=spec["name"], family="dense", num_layers=z["layers"], d_model=z["d"],
        num_heads=z["heads"], num_kv_heads=z["kv_heads"], head_dim=z["head_dim"],
        d_ff=z["ff"], vocab_size=z["vocab"], mlp_type="swiglu",
        rope_theta=float(spec["rope_theta"]), norm_eps=float(spec["rms_norm_eps"]),
        tie_embeddings=z["tied"], dtype=spec["torch_dtype"])
