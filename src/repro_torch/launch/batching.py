"""Continuous batching for serving (the port's counterpart of
`repro/launch/batching.py`).

A fixed pool of decode slots runs one `serve_step_vec` per tick; requests
join free slots as they arrive and leave on EOS or max length, so
throughput stays at the batch-B decode rate instead of draining per
request.  The batch dimension and cache length are fixed and occupancy is
masked, as in the reference (there for jit's static shapes; here the cache
is allocated once).  Dense GQA families, as `serve_step_vec` is.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.kvcache import init_cache


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [S] int32
    max_new: int
    eos_id: int = -1  # -1: never
    # runtime
    generated: List[int] = dataclasses.field(default_factory=list)
    prompt_pos: int = 0

    @property
    def done(self) -> bool:
        if self.generated and self.generated[-1] == self.eos_id:
            return True
        return len(self.generated) >= self.max_new


@dataclasses.dataclass
class EngineStats:
    ticks: int = 0
    tokens_generated: int = 0
    requests_completed: int = 0
    occupancy_sum: float = 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.ticks, 1)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over `serve_step_vec`.

    Per-slot position counters let requests at different depths share one
    step; a slot's cache region is reset just by restarting its position at
    0 (stale cache beyond the mask is never read).  The cache lives on the
    params' device."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 128):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = params.embed.device
        self.cache = init_cache(cfg, slots, max_len, device=self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: Deque[Request] = deque()
        self.pos = np.zeros(slots, np.int64)  # per-slot next position
        self.stats = EngineStats()

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                self.active[i] = self.queue.popleft()
                self.pos[i] = 0

    def _occupancy(self) -> int:
        return sum(r is not None for r in self.active)

    def tick(self) -> List[Tuple[int, int]]:
        """One decode wave. Returns [(uid, token)] emitted this tick."""
        self._admit()
        occ = self._occupancy()
        if occ == 0:
            return []
        # the token batch: prompt tokens (prefill-by-decode) or the last
        # generated token
        toks = np.zeros((self.slots, 1), np.int32)
        for i, r in enumerate(self.active):
            if r is None:
                continue
            if r.prompt_pos < len(r.prompt):
                toks[i, 0] = r.prompt[r.prompt_pos]
            else:
                toks[i, 0] = r.generated[-1] if r.generated else 0
        logits, self.cache = T.serve_step_vec(
            self.cfg, self.params, self.cache,
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(self.pos.copy()).to(self.device))
        nxt = logits.argmax(-1).cpu().numpy().astype(np.int32)
        out = []
        for i, r in enumerate(self.active):
            if r is None:
                continue
            self.pos[i] += 1
            if r.prompt_pos < len(r.prompt):
                r.prompt_pos += 1  # consuming the prompt
                if r.prompt_pos == len(r.prompt):
                    # the tick that ate the LAST prompt token predicts the
                    # first generated token
                    r.generated.append(int(nxt[i]))
                    out.append((r.uid, int(nxt[i])))
                    self.stats.tokens_generated += 1
            else:
                r.generated.append(int(nxt[i]))
                out.append((r.uid, int(nxt[i])))
                self.stats.tokens_generated += 1
            if r.done or self.pos[i] >= self.max_len - 1:
                self.active[i] = None
                self.stats.requests_completed += 1
        self.stats.ticks += 1
        self.stats.occupancy_sum += occ / self.slots
        return out

    def run_until_drained(self, max_ticks: int = 10_000) -> EngineStats:
        for _ in range(max_ticks):
            if not self.queue and self._occupancy() == 0:
                break
            self.tick()
        return self.stats
