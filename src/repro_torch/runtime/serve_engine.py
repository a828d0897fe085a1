"""Slot-based batched serving engine (continuous batching, vLLM-lite).

``BatchedServer`` owns a fixed number of decode *slots* sharing one
``decode_step`` whose ``cache_len`` is a per-slot vector: requests of
different lengths decode together, each attending only to its own logical
prefix (the per-batch ring mask in ``models/lm/attention.py``, plain torch
on every device: the attention kernel has no per-row kv length).  When a
slot finishes (max tokens here; EOS in a real deployment) it is refilled
from the queue by a single-request prefill whose caches are scattered into
the slot — admission never stalls the running batch.  The server owns its
caches and writes the admitted request's into them in place.

Decoder-only token architectures; greedy sampling.  The server runs on
the device its parameters lie on.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.lm.blocks import init_block_cache
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.model import _dtype, decode_step, prefill
from repro_torch.utils.tree import tree_map

__all__ = ["BatchedServer", "Request"]


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # [L] int32
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    def __init__(self, cfg: LMConfig, params, *, slots: int = 4, max_len: int = 256):
        if cfg.encoder_layers > 0 or cfg.input_mode == "embeds":
            raise ValueError("BatchedServer targets decoder-only token archs")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.caches = tuple(
            tree_map(
                lambda a: a.expand(cfg.n_repeats, *a.shape).clone(),
                init_block_cache(cfg, p, slots, max_len, _dtype(cfg), long_mode=False,
                                 device=self.device),
            )
            for p in range(cfg.pattern_period)
        )
        self.cache_len = np.zeros(slots, np.int32)
        self.last_token = np.zeros(slots, np.int32)
        self.active: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self.finished: list[Request] = []

    # ------------------------------------------------------------- intake
    def submit(self, prompt: np.ndarray, max_new: int, req_id: int | None = None) -> Request:
        req = Request(req_id if req_id is not None else len(self.queue), np.asarray(prompt, np.int32), max_new)
        self.queue.append(req)
        return req

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            logits, new_caches = prefill(
                self.params, {"tokens": torch.as_tensor(req.prompt[None, :], device=self.device)},
                self.cfg, cache_size=self.max_len,
            )
            tok = int(torch.argmax(logits[0, : self.cfg.vocab]))
            req.generated.append(tok)

            # scatter the single-request caches into slot s (batch dim = 1
            # of the [R, B, S, ...] leaves)
            def insert(slot_leaf, new_leaf):
                slot_leaf[:, s] = new_leaf[:, 0]

            tree_map(insert, self.caches, new_caches)
            self.cache_len[s] = len(req.prompt)
            self.last_token[s] = tok
            self.active[s] = req

    # --------------------------------------------------------------- step
    def step(self) -> int:
        """Admit + one decode step for all active slots. Returns #active."""
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        tokens = torch.as_tensor(self.last_token[:, None], device=self.device)
        lens = torch.as_tensor(self.cache_len, device=self.device)
        logits, self.caches = decode_step(self.params, tokens, self.caches, lens, self.cfg)
        next_tok = torch.argmax(logits[:, : self.cfg.vocab], dim=-1).cpu().numpy().astype(np.int32)
        n_active = 0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.cache_len[s] += 1
            req.generated.append(int(next_tok[s]))
            self.last_token[s] = next_tok[s]
            if len(req.generated) >= req.max_new or self.cache_len[s] >= self.max_len - 1:
                req.done = True
                self.finished.append(req)
                self.active[s] = None
                self.cache_len[s] = 0
            else:
                n_active += 1
        return n_active + len(self.queue)

    def run(self) -> list[Request]:
        t0 = time.perf_counter()
        steps = 0
        while self.step() or self.queue or any(r is not None for r in self.active):
            steps += 1
            if steps > 100_000:  # safety
                break
        self.elapsed = time.perf_counter() - t0
        return sorted(self.finished, key=lambda r: r.req_id)
