"""Continuous-batching serving engine on NBBS-paged KV memory.

Counterpart of `repro/serve/engine.py` (`Request`, `ServeEngine`).

Host scheduler loop (the paper's concurrency scenario made concrete):
bursts of variable-length requests hit one shared page pool; admission
= buddy allocation success (`memory/kv_cache.PagedKVManager` over the
paper's sequential `NBBSRef` trees), growth = buddy doubling, completion
frees coalesce.  The device step is `serve/paged_decode.paged_decode_step`
(the attention families, dense and MoE) — sequences at arbitrary
positions decode together, through kernel B (`csrc/paged_attention.cu`)
once per layer on the card.

Prefill runs through the dense `serve_prefill` per admitted request and
its KV is written into the sequence's pages on the device, in place
(prompt tokens land exactly at their page/slot addresses; the JAX
engine copies the whole pool through the host instead, with the same
result); decode then proceeds entirely paged.  Each prefill and each
decode step copies its logits to the host once and takes the greedy
argmax there, as the JAX engine does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.memory.kv_cache import PagedKVManager
from repro_torch.models.transformer import ATTENTION_FAMILIES
from repro_torch.serve.paged_decode import init_pool, paged_decode_step, serve_prefill


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """The host-loop engine.  The JAX engine's `impl` switch is gone: the
    attention kernel is picked by the device of the pool (the plain
    version on the CPU, kernel B on the card), as every wrapper of the
    port picks."""

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        num_pages: int = 256,
        page_tokens: int = 16,
        max_batch: int = 8,
        eos_token: Optional[int] = None,
        dtype=torch.float32,
        device="cuda",
        n_shards: int = 1,
        layout: Optional[str] = None,
        max_table_pages: Optional[int] = None,
        log_stats: bool = False,
        fastpath: bool = False,
        fastpath_slab_level: int = 2,
        magazines: int = 0,
        magazine_refill: int = 0,
        mag_lanes: Optional[int] = None,
    ) -> None:
        if cfg.family not in ATTENTION_FAMILIES:  # before any pool is allocated
            raise ValueError(
                "paged engine covers attention families; SSM/hybrid use "
                "fixed-size state slots (see docs/design.md §5)"
            )
        self.cfg = cfg
        self.params = params
        self.page_tokens = page_tokens
        self.max_batch = max_batch
        self.eos = eos_token
        self.dtype = dtype
        self.device = torch.device(device)
        # n_shards > 1 splits the page pool across replicated buddy
        # trees (home-shard hashing + overflow probing; one release
        # burst per shard when sequences retire — see memory/kv_cache).
        # `layout` picks the device tree-state format for wavefront-
        # backed admission ("bunch-packed" = the §III-D packed words,
        # docs/design.md §3); handles and the engine API are unchanged.
        # `fastpath` carves the O(1) bitmap-slab front end out of each
        # shard (core/fastpath.py): single-page runs — decode growth —
        # claim slab slots and spill into the buddy climb when full.
        # `magazines` puts a per-lane LIFO of recycled single pages in
        # front of both (core/magazine.py): freed decode pages park in
        # the retiring sequence group's magazine and the next growth in
        # that group pops them back with zero allocator work.
        self.kv = PagedKVManager(
            num_pages,
            page_tokens,
            n_shards=n_shards,
            layout=layout,
            fastpath=fastpath,
            fastpath_slab_level=fastpath_slab_level,
            magazines=magazines,
            magazine_refill=magazine_refill,
            mag_lanes=mag_lanes if mag_lanes is not None else max_batch,
        )
        # [L, P+1, page, Hkv, D]: page P is the sink of padded rows
        self.pool = init_pool(cfg, num_pages, page_tokens, dtype, self.device)
        # width of the per-sequence block tables handed to the kernel;
        # capping it (e.g. to the longest admissible sequence) keeps the
        # attention gather proportional to sequence capacity instead of
        # pool capacity
        self.max_pages = min(num_pages, max_table_pages or num_pages)
        self.running: Dict[int, Request] = {}
        self.ctx_lens: Dict[int, int] = {}
        self.waiting: List[Request] = []
        self.completed: Dict[int, Request] = {}
        self.stats = {"admitted": 0, "queued_full": 0, "rejected": 0,
                      "steps": 0}
        # opt-in per-step observability (the host-loop counterpart of
        # the jitted engine's schema-checked metrics dict;
        # fragmentation() is an O(tree) host scan, hence the flag)
        self.log_stats = log_stats
        self.step_log: List[dict] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def _admit(self) -> List[Request]:
        admitted = []
        while self.waiting and len(self.running) < self.max_batch:
            req = self.waiting[0]
            need_tokens = len(req.prompt) + req.max_new_tokens
            try:
                admitted_ok = self.kv.add_sequence(req.req_id, need_tokens)
            except ValueError:
                # request exceeds the pool geometry (can never be
                # admitted): reject it instead of letting it head-of-line
                # block the queue forever
                self.waiting.pop(0)
                req.done = True
                self.completed[req.req_id] = req
                self.stats["rejected"] += 1
                continue
            if not admitted_ok:
                self.stats["queued_full"] += 1
                break  # pool full: natural admission control
            self.waiting.pop(0)
            self.running[req.req_id] = req
            self.ctx_lens[req.req_id] = len(req.prompt)
            admitted.append(req)
            self.stats["admitted"] += 1
        return admitted

    def _prefill_into_pages(self, reqs: List[Request]) -> None:
        """Run prefill per request and write its KV into its buddy pages
        on the device, in place."""
        pt = self.page_tokens
        for req in reqs:
            S = len(req.prompt)
            toks = torch.from_numpy(np.asarray(req.prompt, np.int64)[None, :])
            lg, cache = serve_prefill(
                self.cfg, self.params, {"tokens": toks.to(self.device)},
                max_len=S, dtype=self.dtype,
            )
            table = self.kv.block_table(req.req_id, self.max_pages)
            t = np.arange(S)
            page = torch.from_numpy(table[t // pt].astype(np.int64)).to(self.device)
            slot = torch.from_numpy(t % pt).to(self.device)
            self.pool["k"][:, page, slot] = cache["k"][:, 0]  # [L, S, Hkv, D]
            self.pool["v"][:, page, slot] = cache["v"][:, 0]
            req.out_tokens.append(int(np.argmax(lg[0].cpu().numpy())))

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: admit + prefill + one decode step.
        Returns number of running sequences."""
        self._prefill_into_pages(self._admit())
        if not self.running:
            return 0
        ids = sorted(self.running)
        B = len(ids)
        # pad the decode batch to a power-of-two bucket (inactive rows
        # write to the sink page and attend to nothing): bounds the
        # distinct batch shapes to log2(max_batch) + 1, as in JAX
        B2 = 1 << max(B - 1, 0).bit_length()
        tables = np.full((B2, self.max_pages), -1, np.int32)
        tables[:B] = np.stack(
            [self.kv.block_table(i, self.max_pages) for i in ids]
        )
        ctx = np.zeros(B2, np.int32)
        ctx[:B] = [
            self.ctx_lens[i] + len(self.running[i].out_tokens) - 1
            for i in ids
        ]
        toks = np.zeros(B2, np.int32)
        toks[:B] = [self.running[i].out_tokens[-1] for i in ids]
        active = np.arange(B2) < B

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        lg = paged_decode_step(
            self.cfg,
            self.params,
            self.pool,
            dev(tables),
            dev(ctx),
            dev(toks),
            page_tokens=self.page_tokens,
            dtype=self.dtype,
            active=dev(active),
        )
        nxt = np.argmax(lg[:B].cpu().numpy(), axis=-1)
        self.stats["steps"] += 1
        retired = []
        for i, t in zip(ids, nxt):
            req = self.running[i]
            req.out_tokens.append(int(t))
            # pages for prompt+max_new were reserved at admission
            # (guaranteed-completion mode; PagedKVManager.append_tokens
            # provides the grow-on-demand mode, exercised in tests)
            hit_eos = self.eos is not None and int(t) == self.eos
            if len(req.out_tokens) >= req.max_new_tokens or hit_eos:
                req.done = True
                retired.append(i)
                self.completed[i] = req
                del self.running[i]
                del self.ctx_lens[i]
        if retired:
            # all sequences finishing this step release as one burst
            self.kv.free_sequences(retired)
        if self.log_stats:
            frag = self.kv.fragmentation()
            self.step_log.append({
                "step": self.stats["steps"],
                "active_lanes": len(self.running),
                "retired": len(retired),
                "free_pages": frag["free_pages"],
                "largest_run": frag["largest_run"],
            })
        return len(self.running)

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.waiting and not self.running:
                return
            self.step()
