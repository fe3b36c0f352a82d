"""Continuous-batching serving scheduler with a CIDER-managed prefix cache
(port of ``repro.serving.scheduler``).

Host-side control loop: admits requests into free decode slots, allocates
KV pages from a free list, consults the ``PageTable`` for shared-prefix
hits, and recycles pages on completion.  Only the page table touches the
device (the CIDER engine on ``device``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serving.pagetable import PageTable

__all__ = ["Request", "Scheduler"]


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray           # prompt
    max_new: int
    # runtime state
    pages: list = dataclasses.field(default_factory=list)
    pos: int = 0
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    cached_blocks: int = 0


class Scheduler:
    def __init__(self, n_slots: int, n_pages: int, page_size: int,
                 table: PageTable | None = None,
                 device: str | torch.device = "cuda"):
        self.n_slots = n_slots
        self.page_size = page_size
        self.free_pages = list(range(n_pages))
        self.slots: list[Request | None] = [None] * n_slots
        self.queue: list[Request] = []
        self.table = table or PageTable.create(block_tokens=page_size,
                                               device=device)
        self.stats = {"prefix_hits": 0, "prefix_misses": 0, "admitted": 0,
                      "completed": 0}

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self, req: Request) -> bool:
        keys = self.table.block_keys(req.tokens)
        pages_needed = (len(req.tokens) + req.max_new) // self.page_size + 1
        if len(self.free_pages) < pages_needed:
            return False
        if len(keys):
            page_ids, hits, _ = self.table.lookup(keys)
            n_hit = int(np.cumprod(hits).sum()) if len(hits) else 0
        else:
            page_ids, n_hit = np.array([]), 0
        req.cached_blocks = n_hit
        self.stats["prefix_hits"] += n_hit
        self.stats["prefix_misses"] += max(len(keys) - n_hit, 0)
        # reuse hit pages; allocate the rest
        req.pages = [int(page_ids[i]) for i in range(n_hit)]
        for _ in range(pages_needed - n_hit):
            req.pages.append(self.free_pages.pop())
        req.pos = len(req.tokens)
        # publish newly prefilled blocks (combined by CIDER under contention)
        fresh = keys[n_hit:]
        if len(fresh):
            self.table.publish(fresh, req.pages[n_hit:n_hit + len(fresh)])
        self.stats["admitted"] += 1
        return True

    def step_admit(self):
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue[0]
                if self._admit(req):
                    self.queue.pop(0)
                    self.slots[i] = req
                else:
                    break

    def active(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def complete_token(self, slot: int, token: int):
        req = self.slots[slot]
        req.out.append(token)
        req.pos += 1
        if len(req.out) >= req.max_new:
            req.done = True
            self.stats["completed"] += 1
            # release non-shared pages (shared prefix pages stay published)
            for p in req.pages[req.cached_blocks:]:
                self.free_pages.append(p)
            self.slots[slot] = None
