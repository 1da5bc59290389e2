"""The plain reference against the port's serve engine on the CPU, both on
the harness's own weights, and the port adapter's reading of a
configuration file."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import check
from portbench.models.dense_decoder import port_config
from portbench.reference.dense_decoder import Reference, as_run, make_weights, padded_vocab

DATA = Path(__file__).resolve().parent / "data"
HOME = Path(__file__).resolve().parents[1]


def tiny(dtype="float32"):
    spec = json.loads((DATA / "tiny.json").read_text())
    spec["torch_dtype"] = dtype
    return spec


def serve(spec, weights, lengths=(5, 17, 33, 40), new=6, record=True):
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(port_config(spec), params=weights, max_slots=4, max_prompt_len=max(lengths),
                      max_new_tokens=new, record_logits=record, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, spec["vocab_size"], size=n), max_new_tokens=new)
            for n in lengths]
    eng.run()
    assert all(r.done for r in reqs)
    return reqs


def test_weights_are_the_ports_layout_and_follow_the_seed():
    spec = tiny("bfloat16")
    a, b, c = (make_weights(spec, s, "cpu") for s in (3, 3, 4))
    assert a["embed"].shape == (padded_vocab(2000), 256) == (2048, 256)
    assert a["layers"]["attn"]["w_k"].shape == (4, 256, 2 * 64)
    assert a["layers"]["mlp"]["mlp_down"].shape == (4, 512, 256)
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["layers"]["mlp"]["mlp_up"], b["layers"]["mlp"]["mlp_up"])
    assert not torch.equal(a["layers"]["mlp"]["mlp_up"], c["layers"]["mlp"]["mlp_up"])
    assert "lm_head" not in a
    assert make_weights({**spec, "tie_word_embeddings": False}, 3, "cpu")["lm_head"].shape == (256, 2048)


def test_reference_matches_the_engine_prefill_and_decode_in_float32():
    spec = tiny("float32")
    w = make_weights(spec, 7, "cpu")
    reqs = serve(spec, w)
    seqs, pos, toks = check.served(reqs)
    ref = Reference(spec, w).logits(seqs, pos)
    V = spec["vocab_size"]
    for r, lg in zip(reqs, ref):
        got = torch.as_tensor(np.stack(r.logits))[:, :V]
        # first row: the prefill's logits; later rows: decode through the cache
        assert torch.allclose(got, lg, atol=2e-4, rtol=2e-4), float((got - lg).abs().max())
    assert float(check.gaps(ref, toks).max()) < 1e-4


def test_bf16_serving_within_the_smoke_cells_limit_and_the_control_beyond_it():
    spec = tiny("bfloat16")
    w = make_weights(spec, 2**31 + 11, "cpu")
    reqs = serve(spec, w, record=False, new=10)
    seqs, pos, toks = check.served(reqs)
    ref = Reference(spec, w).logits(seqs, pos)
    limit = json.loads((DATA / "tiny.chat.json").read_text())["limits"]["logit_gap"]
    assert float(check.gaps(ref, toks).max()) < limit
    ctl = Reference(spec, w, precision="fp8").logits(seqs, pos)
    assert float(check.gaps(ref, check.control_tokens(ctl)).max()) > limit


def test_port_adapter_takes_the_files_settings():
    spec = json.loads((HOME / "configs" / "granite_3_2b.json").read_text())
    cfg = port_config(as_run(spec))
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (40, 2048, 32, 8, 64, 8192, 49155)
    assert cfg.norm_eps == 1e-5 and cfg.rope_theta == 1e4 and cfg.tie_embeddings
    assert (cfg.falcon_mode, cfg.falcon_backend, cfg.dtype) == ("auto", "cuda", "bfloat16")
    mistral = port_config(as_run(json.loads((HOME / "configs" / "mistral_nemo_12b.json").read_text())))
    assert (mistral.d_model, mistral.head_dim, mistral.d_ff, mistral.rope_theta) == \
        (5120, 128, 14336, 1e6)
    assert not mistral.tie_embeddings


def test_port_adapter_refuses_what_the_port_cannot_run():
    spec = json.loads((HOME / "configs" / "granite_3_2b.json").read_text())
    # the file states Granite's published multipliers, which the port lacks
    assert spec["embedding_multiplier"] == 12.0 and spec["logits_scaling"] == 8.0
    with pytest.raises(ValueError, match="embedding_multiplier"):
        port_config(spec)


def test_reference_follows_the_multipliers_of_its_file():
    spec = tiny("float32")
    w = make_weights(spec, 1, "cpu")
    seq, pos = [[1, 2, 3, 4, 5]], [[4]]
    base = Reference(spec, w).logits(seq, pos)[0]
    halved = Reference({**spec, "logits_scaling": 2.0}, w).logits(seq, pos)[0]
    assert torch.allclose(halved, base / 2)
    assert not torch.allclose(Reference({**spec, "residual_multiplier": 0.5}, w).logits(seq, pos)[0],
                              base)
    # a published value the program departs from: the run reads ``run_as``
    departed = as_run({**spec, "logits_scaling": 2.0, "run_as": {"logits_scaling": 1.0}})
    assert torch.equal(Reference(departed, w).logits(seq, pos)[0], base)
