"""ServeEngine: continuous batching over bucketed, pre-planned step shapes.

The engine owns a fixed set of KV-cache **slots**. Requests are admitted by
the :class:`~repro_torch.serve.scheduler.Scheduler` into free slots via
bucketed prefill micro-batches (prompts right-padded to a power-of-two
sequence bucket, per-row last-token indices pick the true logits), then
advance over the active slots in decode micro-batches padded to a
power-of-two batch bucket. Every step therefore runs a shape from the
closed :class:`~repro_torch.serve.buckets.BucketPolicy` grid, so after
:meth:`warm`:

* the FalconGEMM Decision Module is a pure plan-cache hit per projection
  (``core.engine.warm_buckets`` pre-planned the bucket grid),
* static weights are already lifted to precombined :class:`PlannedWeight`\\ s
  (offline Combine B ran once at load),
* on the card each bucket's step is one captured CUDA graph
  (``serve/step_graphs.py``), replayed with no Python in the step: the
  counterpart of the reference's one jit executable per bucket shape.

On top of that the engine serves four decode features, all riding the same
bucket grid:

* **speculative decoding** (``speculate=γ``): a :class:`DraftModel` proposes
  γ tokens, one ``(B, γ+1)`` verify forward scores them, greedy
  accept/rollback emits 1..γ+1 tokens per round, token-exact against the
  non-speculative engine by construction (``serve/speculative.py``).
* **prefix KV reuse** (``prefix_cache=True``): finished prefills snapshot
  their slot KV into a radix cache keyed by prompt tokens; a later request
  sharing a prefix prefills only the suffix (``serve/prefix_cache.py``).
* **chunked prefill** (``prefill_chunk=N``): long prompts prefill in
  full-bucket chunks the scheduler interleaves with decode work.
* **token streaming**: ``submit(stream=True)`` / ``on_token=`` deliver
  tokens as ``_emit`` produces them.

Correctness of padding: pad rows and positions never leak. Right-padded
prefill writes pad K/V above each request's true length, but decode validity
masks ``kpos < pos + S`` and each write covers its positions before they
first become visible; the same argument covers rejected speculative drafts
and chunk boundaries. SSM/hybrid recurrent state is exact because the
prefill steps zero dt on pad positions (a length mask), so the state
ignores the padded tail; speculation is refused for those families, since
the state cannot roll back past a rejected draft. Pad *rows* of a
micro-batch gather the last real slot's rows, as the reference's do, and
are scattered into one spare slot past ``max_slots``, so the gather, the
forward and the scatter all keep the bucket's shape inside a graph and no
pad row writes a real slot (the spare slot's state takes the pad rows'
state too). The output is token-exact against the reference's engine
(``tests/test_torch_serve_engine.py``, ``tests/test_torch_serve_spec.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue as _queue
import threading
import time

import numpy as np
import torch

import repro_torch.api as falcon
from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.core import engine as core_engine, plan_cache
from repro_torch.models import model as M, moe as MOE
from repro_torch.parallel import collectives as C, mesh as PM, sharding as SH
from repro_torch.train.steps import make_chunk_prefill_step, make_decode_step, make_verify_step

from .buckets import BucketPolicy, next_pow2
from .prefix_cache import RadixPrefixCache, check_kv_cache, snapshot_len, snapshot_rows
from .request import Request, RequestQueue
from .scheduler import DecodeWork, PrefillWork, Scheduler
from .speculative import DraftModel, SelfDraft
from .step_graphs import StepGraphs, rows_step, slot_index
from .stats import ServeStats

__all__ = ["ServeEngine", "StepLoop"]


class ServeEngine:
    """Continuous-batching serve engine for one dense, MoE, SSM or hybrid
    decoder.

    ``submit`` is thread-safe (any frontend thread); ``step``/``run`` are the
    single consumer. Non-token frontends are rejected: the bucket grid
    assumes one int token stream.

    ``speculate=γ`` turns decode steps into speculative rounds (draft γ,
    verify in one forward, accept greedily: token-exact). The draft
    defaults to the identity :class:`SelfDraft` (every layer kept,
    acceptance ≈ 1); pass ``draft_keep_layers`` for a truncated self-draft
    or ``draft=`` for any :class:`DraftModel`.

    The FalconGEMM policy is the ambient config (``falcon.use``) where one
    is installed, else the model's ``falcon_config_for``, as in
    ``launch.serve.run_oneshot``. ``params`` is the port's parameter tree
    (default: ``init_params`` from ``seed`` on ``device``). The engine runs on ``device`` ("cuda" unless
    the caller asks for the CPU, where every kernel wrapper runs its plain
    version); with ``cuda_graphs`` (the default) each bucket's step on the
    card is a captured CUDA graph, without it the same steps run eagerly.

    ``mesh_shape={"data": d, "model": m}`` spanning more than one rank
    serves on this process's mesh (``parallel.mesh.init_mesh``;
    ``launch.serve --mesh`` starts the ranks): every rank builds the same
    engine, gets the same requests and schedules the same steps. The
    weights are replicated over "data" and sharded over "model" by the rule
    table (``parallel.sharding.shard_params``) before precombining, so
    offline Combine B runs on each rank's shard; the cache holds the rank's
    KV heads. Over "data" the cache stays replicated and each step's writes
    are gathered (the reference's "replicated-then-gathered"): the step's
    rows split over the d ranks, each computes its share padded to its
    local bucket of ``ceil(b / d)`` rows (:meth:`_run_rows`), then one
    all-gather over "data" carries what every rank wrote (the K/V of its
    rows at the positions the step wrote, in every layer, the SSM state
    rows, the greedy tokens and, recording, the logits), so every rank
    holds every slot again, and the prefix cache, chunked prefill and
    speculation (whose draft runs the whole micro-batch on every rank) see
    what one device sees. ``warm()`` plans the local shapes each rank
    contracts. A gloo mesh's collectives on the card cross host memory,
    which a CUDA graph cannot capture: such an engine needs
    ``cuda_graphs=False``. A process outside a mesh of that shape raises.
    """

    def __init__(self, model_cfg: ModelConfig, params=None, *,
                 max_slots: int = 8, max_prompt_len: int = 64,
                 max_new_tokens: int = 32, policy: BucketPolicy | None = None,
                 precombine: bool = True, record_logits: bool = False,
                 seed: int = 0, mesh_shape: dict | None = None,
                 quantize: bool = False, speculate: int = 0,
                 draft: DraftModel | None = None,
                 draft_keep_layers: int | None = None,
                 prefix_cache: bool = False, prefix_entries: int = 32,
                 prefill_chunk: int | None = None,
                 max_consecutive_prefills: int = 2,
                 device="cuda", cuda_graphs: bool = True):
        if model_cfg.frontend:
            raise NotImplementedError(
                f"ServeEngine serves token-stream decoders; got "
                f"frontend={model_cfg.frontend!r} (bucketed prefill assumes "
                "one int token stream)")
        self.device = torch.device(device)
        self.mesh = PM.mesh_for(mesh_shape)
        self.data = 1 if self.mesh is None else self.mesh.size("data")
        self.data_rank = 0 if self.mesh is None else self.mesh.local_rank("data")
        if self.mesh is not None and self.device.type == "cuda" and cuda_graphs:
            raise ValueError(
                f"ServeEngine: cuda_graphs=True on a {self.mesh.backend} mesh: a collective "
                "staged through host memory cannot be captured (pass cuda_graphs=False; "
                "capturing nccl steps waits for a machine with a card per rank)")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine: no CUDA device (pass device='cpu' to run "
                               "the kernels' plain versions)")
        self.cfg = model_cfg
        self.gamma = int(speculate)
        if self.gamma < 0:
            raise ValueError(f"speculate must be >= 0, got {speculate}")
        if self.gamma and model_cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"speculate requires a rollback-free cache; family="
                f"{model_cfg.family!r} carries recurrent state that cannot "
                "un-advance past rejected draft tokens")
        self.max_prompt_len = max_prompt_len
        self.prefill_chunk = prefill_chunk
        # with chunking, the bucket grid tops out at the chunk size: longer
        # prompts run as several full-chunk micro-batches
        pol_max_seq = min(max_prompt_len, prefill_chunk) if prefill_chunk \
            else max_prompt_len
        self.policy = policy or BucketPolicy.build(pol_max_seq, max_slots)
        self.max_slots = max_slots
        self.max_new_tokens_cap = max_new_tokens
        # speculation writes up to γ provisional positions past the last
        # committed token, so the slot length budgets for them
        self.max_len = next_pow2(
            max(self.policy.prefill_seq[-1], max_prompt_len)
            + max_new_tokens + self.gamma)
        self.record_logits = record_logits
        self.mesh_shape = dict(mesh_shape or {})
        self.quantize = bool(quantize)
        self.fcfg = falcon.active_config() or M.falcon_config_for(model_cfg)
        if self.quantize:
            # the Decision Module prices the int8 tier beside fp (plan-cache
            # keys gain the quant token), precombine bakes B̃q + scales into
            # each PlannedWeight, and warm() pre-plans the quantized buckets
            self.fcfg = dataclasses.replace(self.fcfg, quantize=True)
        self.graphs = StepGraphs(self.device, cuda_graphs)
        with self._ctx():
            self.params = params if params is not None \
                else M.init_params(model_cfg, seed, self.device)
            if self.mesh is not None:
                # tensor-parallel at rest: shard the raw weights BEFORE
                # precombining, so offline Combine B runs on each rank's shard
                self.params = SH.shard_params(self.params, model_cfg, self.mesh)
            self.draft: DraftModel | None = draft
            if self.gamma and self.draft is None:
                # built from RAW params: a layer slice of a precombined tree
                # would tear PlannedWeights; a sliced draft precombines its
                # own copy below
                self.draft = SelfDraft(model_cfg, self.params, max_slots=max_slots,
                                       max_len=self.max_len, keep_layers=draft_keep_layers,
                                       graphs=self.graphs)
            self.n_precombined = 0
            if precombine:
                # Offline Combine B priced at the largest prefill bucket M;
                # each step re-decides per its actual bucket M (plan-cached).
                m_hint = self.policy.prefill_batch[-1] * self.policy.prefill_seq[-1]
                raw = self.params
                self.params, self.n_precombined = falcon.precombine_params(
                    self.params, m_hint=m_hint)
                if isinstance(self.draft, SelfDraft):
                    # the identity draft shares the target's tree
                    self.draft.params = self.params if self.draft.params is raw else \
                        falcon.precombine_params(self.draft.params, m_hint=m_hint)[0]
            # one spare slot past max_slots takes the pad rows' writes
            self.cache = M.init_cache(model_cfg, max_slots + 1, self.max_len,
                                      device=self.device)
        self.spare = max_slots
        self.queue = RequestQueue()
        self.scheduler = Scheduler(
            self.queue, self.policy, max_slots,
            max_consecutive_prefills=max_consecutive_prefills,
            prefill_chunk=prefill_chunk)
        self.stats = ServeStats()
        self.requests: list[Request] = []
        self.prefix = RadixPrefixCache(max_entries=prefix_entries) \
            if prefix_cache else None
        self.pos = np.zeros(max_slots, np.int64)   # per-slot next write index
        self._step_fns = {"prefill": make_chunk_prefill_step(model_cfg),
                          "decode": make_decode_step(model_cfg),
                          "spec": make_verify_step(model_cfg)}
        self._compiled: set[tuple] = set()          # the engine's step shapes made so far
        self._submit_lock = threading.Lock()

    @contextlib.contextmanager
    def _ctx(self):
        """The engine's FalconGEMM policy and mesh, in inference mode."""
        with falcon.use(self.fcfg), PM.use_mesh(self.mesh), torch.inference_mode():
            yield

    # -- admission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int | None = None,
               eos_id: int | None = None, stream: bool = False,
               on_token=None) -> Request:
        """Queue one generation request.

        ``stream=True`` attaches a consumer queue: iterate
        ``req.token_stream()`` from any thread while the engine steps.
        ``on_token(req, tok)`` is called synchronously from the step loop for
        every emitted token (keep it cheap: it sits on the decode path).
        """
        req = Request(prompt=prompt,
                      max_new_tokens=max_new_tokens or self.max_new_tokens_cap,
                      eos_id=eos_id)
        if self.prefill_chunk:
            if req.prompt_len > self.max_prompt_len:
                raise ValueError(
                    f"prompt_len={req.prompt_len} exceeds engine "
                    f"max_prompt_len={self.max_prompt_len}")
        else:
            self.policy.seq_bucket(req.prompt_len)  # raises if off-grid
        if req.max_new_tokens > self.max_new_tokens_cap:
            raise ValueError(
                f"max_new_tokens={req.max_new_tokens} exceeds engine cap "
                f"{self.max_new_tokens_cap} (cache is sized for the cap)")
        if stream:
            req.stream_q = _queue.Queue()
        req.on_token = on_token
        with self._submit_lock:                     # frontend threads race here
            self._lookup_prefix(req)
            self.queue.submit(req)
            self.requests.append(req)
            self.stats.requests_admitted += 1
        return req

    def _lookup_prefix(self, req: Request) -> None:
        """Pin the longest cached prefix of ``prompt[:-1]`` for this request.

        The last prompt token is always excluded so at least one suffix token
        prefills: the request's first logits are always freshly computed,
        and an SSM/hybrid snapshot (state valid only at its exact length) is
        only ever resumed at exactly that length.
        """
        if self.prefix is None:
            return
        n, entry = (0, None) if req.prompt_len < 2 else \
            self.prefix.lookup(req.prompt[:-1], pin=True)
        if entry is not None and self.draft is not None \
                and "draft" not in entry.payload:
            self.prefix.release(entry)              # no draft KV: unusable
            entry = None
        if entry is None:
            self.stats.prefix_misses += 1
            return
        req.prefix_len, req.prefix_entry = n, entry
        self.stats.prefix_hits += 1
        self.stats.prefix_tokens_reused += n

    # -- steps ---------------------------------------------------------------

    def _make_step(self, key: tuple):
        """The engine's step of ``key``: ("prefill", B, S), ("decode", b) or
        ("spec", b). A new one is warmed up and, on the card, captured."""
        def make():
            kind, b = key[:2]
            width = {"prefill": key[-1], "decode": 1, "spec": self.gamma + 1}[kind]
            inputs = {"tokens": (b, width), "index": (b,), "gidx": (b,), "sidx": (b,)}
            if kind == "prefill":
                inputs["last"] = (b,)
            # the step holds the weights and the cache, not the engine: a
            # dropped engine is freed at once, graphs and all
            fn = rows_step(self._step_fns[kind], self.params, self.cache)
            return fn, inputs, {"gidx": self.spare, "sidx": self.spare}
        self._compiled.add(key)
        return self.graphs.get(key, make)

    def _note_shape(self, key: tuple):
        """Count a bucket hit (a step shape already made) or miss; return the step."""
        if key in self._compiled:
            self.stats.bucket_hits += 1
        else:
            self.stats.bucket_misses += 1
        return self._make_step(key)

    # -- warmup --------------------------------------------------------------

    def warm(self) -> dict:
        """Pre-plan and prepare the whole bucket grid.

        1. ``core.engine.warm_buckets`` runs the Decision Module for every
           contraction the workload registry enumerates at every (batch,
           seq) bucket of the grid (dense projections and attention
           contractions, plus under ``speculate=γ`` the ``(b, γ+1)`` verify
           and ``(b, 2)`` draft catch-up contexts), so serving only hits the
           plan cache.
        2. Each (phase, shape) step (prefill chunks, decode or verify
           rounds, and the draft's own steps) runs once on zero inputs and,
           on the card with graphs on, is captured as a CUDA graph, so no
           live request pays a first run or a capture.

        Returns ``plans``, ``shapes`` (the engine's own step shapes), and
        ``seconds``, split into ``plan_seconds`` and ``capture_seconds``
        (of which ``map_seconds`` counting the graphs' nodes for their
        capture maps), with the number of ``graphs`` and the graph pool's
        ``pool_bytes``.
        """
        t0 = time.perf_counter()
        grid = (list(self.policy.prefill_shapes())
                + [(b, 1) for b in self.policy.decode_batch])
        with self._ctx():
            n_plans = core_engine.warm_buckets(
                self.fcfg, self.cfg, grid, dtype=str(self.cfg.dtype),
                kv_len=self.max_len, spec_gamma=self.gamma or None,
                mesh_shape=self.mesh_shape if self.mesh is not None else None)
            if self.data > 1 and self.draft is not None:
                # the draft runs each whole micro-batch on every data rank
                n_plans += core_engine.warm_buckets(
                    self.fcfg, self.cfg, grid, dtype=str(self.cfg.dtype),
                    kv_len=self.max_len, spec_gamma=self.gamma,
                    mesh_shape={"data": 1, "model": self.mesh.size("model")})
            t_plan = time.perf_counter() - t0
            captured = self.graphs.seconds
            for (b, s) in self.policy.prefill_shapes():
                self._make_step(("prefill", PM.data_rows(b, self.data)[0], s))
            kind = "spec" if self.gamma else "decode"
            for b in self.policy.decode_batch:
                self._make_step((kind, PM.data_rows(b, self.data)[0]))
            if self.draft is not None:
                self.draft.warm(self.policy, self.gamma)
        self.stats.warm_plans = n_plans
        self.stats.warmed_shapes = len(self._compiled)
        self.stats.t_warm = time.perf_counter() - t0
        return {"plans": n_plans, "shapes": len(self._compiled),
                "seconds": self.stats.t_warm, "plan_seconds": t_plan,
                "capture_seconds": self.graphs.seconds - captured,
                "map_seconds": self.graphs.map_seconds,
                "graphs": self.graphs.n_graphs, "pool_bytes": self.graphs.pool_bytes()}

    # -- step loop -----------------------------------------------------------

    def step(self) -> bool:
        """Run one scheduler-selected micro-batch. False when idle.

        Spans (``repro_torch.trace``): ``serve.step`` around it, inside it
        ``serve.schedule``, ``serve.inputs`` (host arrays, then the load:
        one host-to-device copy), ``serve.launch`` (the step's graph replay,
        or its eager run; ``key``, and ``map``: the graph's capture map),
        ``serve.readback`` (the one synchronization) and ``serve.emit``."""
        with trace.span("serve.step"):
            with trace.span("serve.schedule"):
                work = self.scheduler.next_work()
            if work is None:
                return False
            with self._ctx():
                if isinstance(work, PrefillWork):
                    self._run_prefill(work)
                elif self.gamma:
                    self._run_spec_decode(work)
                else:
                    self._run_decode(work)
            return True

    def run(self, max_steps: int | None = None) -> list[Request]:
        """Step until idle (or ``max_steps``); returns finished requests."""
        steps = 0
        while max_steps is None or steps < max_steps:
            if not self.step():
                break
            steps += 1
        return [r for r in self.requests if r.done]

    # -- execution -----------------------------------------------------------

    def _read(self, greedy, logits):
        """The step's one synchronization: greedy tokens (and, recording,
        the logits) to the host."""
        return (greedy.cpu().numpy(),
                logits.float().cpu().numpy() if self.record_logits else None)

    def _run_rows(self, key: tuple, slots, last_only: bool, **arrays):
        """Run the step ``key`` = (kind, b, ...) on a micro-batch of ``b``
        rows whose first rows are the real ones, of ``slots``; ``arrays``
        are the step's host inputs, ``b`` rows each. Returns the greedy
        tokens and, recording, the logits on the host, ``b`` rows (the last
        position only where ``last_only``).

        Over a data axis of d ranks the rows are padded to ``d * lb``
        (``lb = ceil(b / d)``, repeating the last row; ``parallel.mesh.
        data_rows``), each rank runs its ``lb`` of them through its local
        step (pad rows, and a rank with no real row, gather the last real
        slot and scatter into the spare one), its MoE layers routing as one
        device routes the ``b`` rows (``models.moe.route_over_data``), and
        one all-gather over "data" returns what every rank wrote, which
        every rank then writes into its cache: the K/V at the positions
        ``[index, index + width)`` of its rows, the SSM state rows, the
        greedy tokens and the logits."""
        b = key[1]
        lb, mine = PM.data_rows(b, self.data, self.data_rank)
        n = lb * self.data
        with trace.span("serve.inputs"):
            if n > b:
                arrays = {name: np.concatenate([a, np.repeat(a[-1:], n - b, axis=0)])
                          for name, a in arrays.items()}
            gidx, sidx = slot_index(slots, n, self.spare)
            key = (key[0], lb, *key[2:])
            step = self._note_shape(key)
            step.load(**{name: a[mine] for name, a in arrays.items()},
                      gidx=gidx[mine], sidx=sidx[mine])
        with trace.span("serve.launch", key=key, map=step.map), MOE.route_over_data(b):
            greedy, logits = step()
        if self.data > 1:
            greedy, logits = self._gather_rows((greedy, logits), step.inputs,
                                               arrays["index"], sidx)
        if last_only:
            greedy, logits = greedy[:, -1], logits[:, -1]
        with trace.span("serve.readback"):
            return self._read(greedy[:b], logits[:b])

    def _gather_rows(self, out, inputs: dict, index: np.ndarray, sidx: np.ndarray):
        """After a data rank's step: one all-gather over "data" of what each
        rank computed (its greedy tokens, its logits when recorded, and the
        cache entries its rows wrote), written into this rank's cache.
        Returns the greedy tokens and logits of all ranks' rows."""
        greedy, logits = out
        width = inputs["tokens"].shape[1]
        cols = torch.arange(width, device=self.device)
        rows, pos = inputs["sidx"], inputs["index"][:, None] + cols
        parts = {"greedy": greedy}
        if self.record_logits:
            parts["logits"] = logits
        for name, c in self.cache.items():
            parts[name] = (c[:, rows] if name == "state" else c[:, rows[:, None], pos]).movedim(1, 0)
        got = C.all_gather_rows(parts, self.mesh, "data")
        rows = torch.as_tensor(sidx, device=self.device)
        pos = torch.as_tensor(index, device=self.device)[:, None] + cols
        for name, c in self.cache.items():
            if name == "state":
                c[:, rows] = got[name].movedim(0, 1)
            else:
                c[:, rows[:, None], pos] = got[name].movedim(0, 1)
        # not recording, the greedy tokens stand in for the logits (unread)
        return got["greedy"], got.get("logits", got["greedy"])

    def _run_prefill(self, work: PrefillWork) -> None:
        B, S = work.batch_pad, work.seq_pad
        k = len(work.requests)
        # first chunk of a prefix hit: copy the reused KV into the slot
        # before this chunk's rows are gathered
        for i, r in enumerate(work.requests):
            if r.prefix_entry is not None and work.starts[i] == r.prefix_len:
                self._load_prefix(work.slots[i], r)
        with trace.span("serve.inputs"):
            toks = np.zeros((B, S), np.int64)
            last = np.zeros((B,), np.int64)
            start = np.zeros((B,), np.int64)
            for i, r in enumerate(work.requests):
                n = work.lengths[i]
                toks[i, :n] = r.prompt[work.starts[i]:work.starts[i] + n]
                last[i] = n - 1
                start[i] = work.starts[i]
        t0 = time.perf_counter()
        if self.draft is not None:
            self.draft.prefill_chunk(toks, start, last, work.slots, k)
        greedy, logits = self._run_rows(("prefill", B, S), work.slots, True,
                                        tokens=toks, index=start, last=last)
        now = time.perf_counter()
        with trace.span("serve.emit"):
            self.stats.t_prefill += now - t0
            self.stats.prefill_steps += 1
            self.stats.prompt_tokens += work.real_tokens
            self.stats.prefill_padded_tokens += work.padded_tokens
            for i, r in enumerate(work.requests):
                r.prefilled = work.starts[i] + work.lengths[i]
                if not work.final[i]:
                    continue                    # chunk done; more prompt to go
                if self.prefix is not None and r.prompt_len > 1:
                    self._insert_prefix(r, work.slots[i])
                self.pos[work.slots[i]] = r.prompt_len
                r.first_token_t = now
                self.stats.generated_tokens += 1
                self._emit(r, int(greedy[i]), None if logits is None else logits[i])

    # -- prefix cache --------------------------------------------------------

    def _load_prefix(self, slot: int, req: Request) -> None:
        """Copy a pinned prefix snapshot into ``slot``; release the pin."""
        entry = req.prefix_entry
        n = len(entry.tokens)
        for name, c in check_kv_cache(self.cache).items():
            snapshot_rows(name, c, slot, n).copy_(entry.payload[name])
        if self.draft is not None:
            self.draft.load(slot, entry.payload["draft"], n)
        self.prefix.release(entry)
        req.prefix_entry = None

    def _insert_prefix(self, req: Request, slot: int) -> None:
        """Snapshot the freshly prefilled prompt KV (and state) under its
        token key.

        Attention K/V slices to any length, so a K/V-only entry is keyed at
        ``prompt[:-1]``: the longest key :meth:`_lookup_prefix` can ever
        match (it always leaves one suffix token to prefill), which makes an
        identical resubmission a full hit. A recurrent ``state`` snapshot is
        valid only at its exact length, so a state-bearing entry is keyed at
        the whole prompt and serves only prompts that extend it
        (``prefix_cache.snapshot_len``). Snapshots stay on the device.
        """
        n = snapshot_len(self.cache, req.prompt_len)
        if n < 1:
            return
        payload = {name: snapshot_rows(name, c, slot, n).clone()
                   for name, c in check_kv_cache(self.cache).items()}
        if self.draft is not None:
            payload["draft"] = self.draft.snapshot(slot, n)
        self.prefix.insert(tuple(req.prompt[:n]), payload)

    # -- decode --------------------------------------------------------------

    def _run_decode(self, work: DecodeWork) -> None:
        b = work.batch_pad
        with trace.span("serve.inputs"):
            toks = np.zeros((b, 1), np.int64)
            pos = np.zeros((b,), np.int64)
            for i, r in enumerate(work.requests):
                toks[i, 0] = r.generated[-1]
                pos[i] = self.pos[work.slots[i]]
        t0 = time.perf_counter()
        greedy, logits = self._run_rows(("decode", b), work.slots, True, tokens=toks, index=pos)
        with trace.span("serve.emit"):
            self.stats.t_decode += time.perf_counter() - t0
            self.stats.decode_steps += 1
            self.stats.generated_tokens += work.real_tokens
            self.stats.decode_real_rows += work.real_tokens
            self.stats.decode_emitted_tokens += work.real_tokens
            self.stats.decode_padded_tokens += work.padded_tokens
            for i, r in enumerate(work.requests):
                self.pos[work.slots[i]] += 1
                self._emit(r, int(greedy[i]), None if logits is None else logits[i])

    def _run_spec_decode(self, work: DecodeWork) -> None:
        """One speculative round: draft γ, verify in one forward, accept.

        Per row: feed ``[t_last, d_1..d_γ]`` at the slot position, take the
        verify argmaxes ``t'_0..t'_γ``, accept drafts while ``d_j ==
        t'_{j-1}``, emit ``t'_0..t'_{n_acc}`` (always ≥ 1: the bonus token
        means a round never stalls). Rejected draft K/V stays in the cache
        above the new position and is overwritten before validity ever
        admits it, so rollback costs nothing.
        """
        k = len(work.slots)
        b = work.batch_pad
        g = self.gamma
        gidx, _ = slot_index(work.slots, b, self.spare)
        last2 = np.zeros((b, 2), np.int64)
        pos = np.zeros((b,), np.int64)
        for i, r in enumerate(work.requests):
            last2[i] = r.tokens[-2:]
            pos[i] = self.pos[work.slots[i]]
        last2[k:] = last2[k - 1]            # pad rows mirror the last real row
        pos[k:] = pos[k - 1]
        t0 = time.perf_counter()
        drafts = self.draft.propose(gidx, last2, pos, g, k)      # (b, γ)
        verify = np.concatenate([last2[:, 1:], drafts], axis=1)
        greedy, logits = self._run_rows(("spec", b), work.slots, False,
                                        tokens=verify, index=pos)  # (b, γ+1[, V])
        self.stats.t_decode += time.perf_counter() - t0
        self.stats.verify_steps += 1
        self.stats.drafted_tokens += g * k
        self.stats.decode_real_rows += k * (g + 1)
        self.stats.decode_padded_tokens += b * (g + 1)
        for i, r in enumerate(work.requests):
            n_acc = 0
            while n_acc < g and int(drafts[i, n_acc]) == int(greedy[i, n_acc]):
                n_acc += 1
            self.stats.accepted_tokens += n_acc
            emitted = 0
            for j in range(n_acc + 1):
                emitted += 1
                self._emit(r, int(greedy[i, j]), None if logits is None else logits[i, j])
                if r.done:
                    break                   # budget/eos cut mid-acceptance
            self.pos[work.slots[i]] += emitted
            self.stats.generated_tokens += emitted
            self.stats.decode_emitted_tokens += emitted

    def _emit(self, req: Request, tok: int, logits_row=None) -> None:
        """Deliver one generated token; retire the request when finished."""
        req.generated.append(tok)
        if self.record_logits and logits_row is not None:
            req.logits.append(np.asarray(logits_row).copy())
        if req.on_token is not None:
            req.on_token(req, tok)
        if req.stream_q is not None:
            req.stream_q.put(tok)
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if hit_eos or len(req.generated) >= req.max_new_tokens:
            req.state = "done"
            req.finish_t = time.perf_counter()
            self.scheduler.release(req)
            self.stats.requests_finished += 1
            if req.stream_q is not None:
                req.stream_q.put(None)      # end-of-stream sentinel

    # -- observability -------------------------------------------------------

    def summary(self) -> dict:
        """ServeStats + the process plan cache, one coherent snapshot, with
        the reference's keys; ``cuda_graphs`` says whether the steps ran as
        captured graphs (``graphs`` of them) or eagerly. On a mesh, also its
        backend and its collectives' counters (``parallel.mesh.Mesh.summary``:
        calls, staged bytes, milliseconds)."""
        d = self.stats.as_dict()
        d["plan_cache"] = plan_cache.stats().as_dict()
        d["plan_cache"]["entries"] = len(plan_cache.default_cache())
        d["precombined_weights"] = self.n_precombined
        d["quantize"] = self.quantize
        d["max_len"] = self.max_len
        d["max_slots"] = self.max_slots
        d["speculate"] = self.gamma
        d["prefix_cache"] = None if self.prefix is None else self.prefix.stats()
        d["prefill_chunk"] = self.prefill_chunk
        d["mesh"] = self.mesh_shape or None
        d["n_devices"] = 1
        if self.mesh is not None:
            d.update(self.mesh.summary())
        d["cuda_graphs"] = self.graphs.enabled
        d["graphs"] = self.graphs.n_graphs
        return d


class StepLoop:
    """Drives a :class:`ServeEngine` until its queue and slots drain.

    A thin synchronous loop for CLI/batch use; a real deployment would run
    this on a dedicated thread while frontend threads ``submit``.
    """

    def __init__(self, engine: ServeEngine, max_steps: int | None = None):
        self.engine = engine
        self.max_steps = max_steps

    def run_until_idle(self, poll_s: float = 0.0) -> list[Request]:
        """Drain the engine; ``max_steps`` bounds total steps across both the
        initial drain and the polling phase (a watchdog for wedged work)."""
        steps = 0
        while self.max_steps is None or steps < self.max_steps:
            if self.engine.step():
                steps += 1
            elif poll_s and not self.engine.scheduler.idle:
                time.sleep(poll_s)
            else:
                break
        return [r for r in self.engine.requests if r.done]
