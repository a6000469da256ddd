"""Continuous-batching serving engine with the SkyByte scheduler (port of
``repro/serving/engine.py``; the host policy is copied word for word).

The engine is the OS half of the co-design: it owns policy (who runs, what
gets promoted/evicted, when the log compacts) while core/tiering.py owns
the device data path — mirroring the paper's host-OS / SSD-controller split.

Per decode step:
  1. residency check — a request is READY iff all its KV pages are in the
     fast pool. Non-resident requests are PARKED (the coordinated context
     switch) and their pages are queued for promotion.
  2. promotion — up to ``promote_pages_per_step`` host->fast page copies
     (the migration bandwidth budget); LRU eviction of non-scheduled
     requests' pages under pool pressure.
  3. batch — up to ``batch`` READY requests, least-served-first (CFS).
  4. decode — one paged+logged token per scheduled request (device op).
  5. compaction — when the log can't hold another step, coalesce it into
     resident pages (fast pool) and parked pages (host tier), then clear.

The policy reads only host-side copies of the page table, lengths,
compaction watermark, log tail and log meta rows, which the engine updates
alongside the device state. So a step reads the card once (the sampled
tokens) and a prefill once (its first token).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import tiering
from repro_torch.core.tiering import TieredKVConfig, host_slot
from repro_torch.models.api import ModelSpec


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)
    served: int = 0  # CFS accounting
    done: bool = False


@dataclasses.dataclass
class ServeStats:
    steps: int = 0
    decoded_tokens: int = 0
    parks: int = 0  # coordinated context switches
    promoted_pages: int = 0
    evicted_pages: int = 0
    compactions: int = 0
    flushed_pages: int = 0
    flushed_tokens: int = 0

    @property
    def coalesce_ratio(self) -> float:
        """Tokens coalesced per flushed page-write (the paper's write-
        amplification win: 1 page write per page_size-token window instead
        of per token)."""
        return self.flushed_tokens / max(self.flushed_pages, 1)


class TieredEngine:
    def __init__(self, spec: ModelSpec, params, kv_cfg: TieredKVConfig, device="cuda"):
        self.device = resolve_device(device)
        self.spec = spec
        self.cfg = spec.cfg
        self.kv = kv_cfg
        self.params = params
        self.state = tiering.init_state(kv_cfg, spec.cfg, dtype=torch.bfloat16, device=self.device)
        self.step_fn = tiering.build_paged_decode_step(spec, kv_cfg)
        self.requests: Dict[int, Request] = {}
        # host-side metadata
        self.hbm_owner: List[Optional[tuple]] = [None] * kv_cfg.n_hbm_pages
        self.lru: np.ndarray = np.zeros(kv_cfg.n_hbm_pages, np.int64)
        self.stats = ServeStats()
        self._clock = 0
        # host copies of the device state the policy reads (no device syncs)
        self.page_table = np.full((kv_cfg.max_requests, kv_cfg.max_pages_per_req), -1, np.int32)
        self.lengths = np.zeros(kv_cfg.max_requests, np.int32)
        self.compacted = np.zeros(kv_cfg.max_requests, np.int32)
        self.log_meta = np.full((kv_cfg.log_slots, 2), -1, np.int32)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without stalling the host (a pinned
        staging copy, sent asynchronously on the current stream)."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ---- admission ----
    def add_request(self, req: Request) -> None:
        if len(self.requests) >= self.kv.max_requests:
            raise ValueError("slots exhausted")
        max_pages = -(-(len(req.prompt) + req.max_new_tokens) // self.kv.page_size)
        if max_pages > self.kv.n_hbm_pages:
            raise ValueError(
                f"request needs up to {max_pages} pages > fast pool "
                f"{self.kv.n_hbm_pages}; enlarge the pool or page size"
            )
        if max_pages > self.kv.max_pages_per_req:
            raise ValueError("max_pages_per_req too small")
        rid = req.rid
        self.requests[rid] = req
        prompt = self._upload(np.asarray(req.prompt, np.int64)[None])
        logits, cache = self.spec.prefill(self.params, prompt)
        k = cache["k"][:, 0]  # (L, S, KV, hd)
        v = cache["v"][:, 0]
        # initial placement: prompt KV lands in the HOST tier (the paper's
        # "all data starts in the CXL-SSD")
        tiering.write_prefill_pages(self.kv, self.state, rid, k, v)
        self.lengths[rid] = self.compacted[rid] = len(req.prompt)
        # the prompt's next token comes from the prefill logits
        req.out.append(int(torch.argmax(logits[0])))
        req.served += 1
        self.stats.decoded_tokens += 1

    # ---- residency / promotion ----
    def _pages_needed(self, req: Request) -> List[int]:
        # attention reads pages only below the compaction watermark; newer
        # positions live in the (always-resident) write log
        compacted = int(self.compacted[req.rid])
        n = (compacted + self.kv.page_size - 1) // self.kv.page_size
        return list(range(n))

    def _resident(self, rid: int, logical: int) -> bool:
        return int(self.page_table[rid, logical]) >= 0

    def _set_page(self, rid: int, logical: int, slot: int) -> None:
        self.page_table[rid, logical] = slot
        self.state["page_table"][rid, logical] = slot

    def _free_slot(self, protect: set) -> Optional[int]:
        for s, owner in enumerate(self.hbm_owner):
            if owner is None:
                return s
        # LRU eviction among non-protected pages (clean by construction:
        # the log owns all un-flushed writes — the paper's key invariant)
        order = np.argsort(self.lru)
        for s in order:
            if self.hbm_owner[s] is not None and self.hbm_owner[s] not in protect:
                rid, logical = self.hbm_owner[s]
                self._set_page(rid, logical, -1)
                self.hbm_owner[s] = None
                self.stats.evicted_pages += 1
                return int(s)
        return None

    def _promote(self, rid: int, logical: int, protect: set) -> bool:
        slot = self._free_slot(protect)
        if slot is None:
            return False
        tiering.copy_pages(
            self.state["hbm_k"], self.state["hbm_v"],
            self.state["host_k"], self.state["host_v"],
            [(host_slot(self.kv, rid, logical), slot)],
        )
        self._set_page(rid, logical, slot)
        self.hbm_owner[slot] = (rid, logical)
        self.lru[slot] = self._clock
        self.stats.promoted_pages += 1
        return True

    # ---- compaction ----
    def _compact(self) -> None:
        dirty = {}
        for owner, pos in self.log_meta:
            if owner >= 0 and pos >= 0:
                dirty.setdefault((int(owner), int(pos) // self.kv.page_size), 0)
                dirty[(int(owner), int(pos) // self.kv.page_size)] += 1
        flush_hbm, flush_host = [], []
        for (rid, logical), ntok in sorted(dirty.items()):
            slot = int(self.page_table[rid, logical])
            if slot >= 0:
                flush_hbm.append([rid, logical, slot])
            # ALWAYS flush to the host backing store (write-back tier);
            # resident copies are updated in parallel (paper: cache updated
            # alongside the log so flushes need no merge read)
            flush_host.append([rid, logical, host_slot(self.kv, rid, logical)])
            self.stats.flushed_pages += 1
            self.stats.flushed_tokens += ntok
        # host lists: compact_log joins them and uploads one table
        tiering.compact_log(self.kv, self.state, flush_hbm, flush_host)
        self.log_meta[:] = -1
        self.compacted[:] = self.lengths
        self.stats.compactions += 1

    # ---- one engine step ----
    def step(self) -> None:
        self._clock += 1
        active = [r for r in self.requests.values() if not r.done]
        if not active:
            return
        # 0. compact BEFORE the residency check: compaction advances the
        # watermark, which can create page demand — readiness must be
        # evaluated against the post-compaction layout
        if self.state["log_tail"] + self.kv.batch > self.kv.log_slots:
            self._compact()
        # 1. residency + parking (the coordinated context switch)
        ready, parked = [], []
        for r in active:
            missing = [p for p in self._pages_needed(r) if not self._resident(r.rid, p)]
            if missing:
                parked.append((r, missing))
            else:
                ready.append(r)
        # 2. promotion budget — closest-to-ready parked request first (SJF:
        # guarantees progress), just-promoted pages join the protect set so
        # the budget loop cannot evict its own work
        budget = self.kv.promote_pages_per_step
        protect = {(r.rid, p) for r in ready for p in self._pages_needed(r)}
        parked.sort(key=lambda rm: len(rm[1]))
        for r, missing in parked:
            self.stats.parks += 1
            for p in missing:
                if budget <= 0:
                    break
                if self._promote(r.rid, p, protect):
                    protect.add((r.rid, p))
                    budget -= 1
        # 3. schedule ready requests, least-served first (CFS)
        ready.sort(key=lambda r: r.served)
        batch = ready[: self.kv.batch]
        if not batch:
            return
        # 4. decode one token for the batch
        B = self.kv.batch
        req_ids = np.full((B,), -1, np.int32)
        tokens = np.zeros((B, 1), np.int64)
        for i, r in enumerate(batch):
            req_ids[i] = r.rid
            last = r.out[-1] if r.out else r.prompt[-1]
            tokens[i, 0] = last
        tail = self.state["log_tail"]
        for i in range(B):  # the meta rows the append kernel writes
            rid = int(req_ids[i])
            self.log_meta[tail + i] = (rid, self.lengths[rid] if rid >= 0 else -1)
        next_tok, self.state = self.step_fn(
            self.params, self.state, self._upload(tokens), self._upload(req_ids)
        )
        next_np = next_tok.cpu().numpy()  # the step's one read of the card
        for i, r in enumerate(batch):
            self.lengths[r.rid] += 1
            r.out.append(int(next_np[i, 0]))
            r.served += 1
            # touch LRU for this request's pages
            for p in self._pages_needed(r):
                s = int(self.page_table[r.rid, p])
                if s >= 0:
                    self.lru[s] = self._clock
            if r.served >= r.max_new_tokens:
                r.done = True
            self.stats.decoded_tokens += 1
        self.stats.steps += 1

    def run(self, max_steps: int = 1000) -> ServeStats:
        for _ in range(max_steps):
            if all(r.done for r in self.requests.values()):
                break
            self.step()
        return self.stats
