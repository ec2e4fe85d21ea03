"""Batched serving driver: slot-based continuous batching (counterpart of
``repro.serve.driver``).

A fixed pool of B decode slots advances in lockstep, one decode step per
tick; requests stream in and out of slots as they finish.  Every slot
shares one cache at a fixed ``max_seq``, so admission is a prefill of the
prompt spliced into the slot.  The decode step takes one position for all
slots, so the driver admits a request only when its prompt length equals
the shared position (prompts of one wave have one length), as the
reference does.

On the device of the parameters: the pooled cache is written in place
(the splice, and each decode step), and a tick reads the host once, for
the sampled tokens.  Unlike the reference's, the splice puts a hybrid
model's mamba caches at their own batch axis (the reference's writes the
layer axis and fails there).  ``kv_quant`` pools the int8 KV cache (its
scales splice with it).  An audio model's prompts are [plen, CB] and each
emitted token a list of CB codes.  As in the reference, there is no
vision input: a vlm model is served on its tokens alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.serve.engine import (greedy_sample, make_decode_step,
                                      make_prefill_step)

PyTree = Any


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [plen] token ids (audio [plen, CB])
    max_new: int
    out: List[Any] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Lockstep slot server over (prefill step, decode step)."""

    def __init__(self, cfg: ArchConfig, params: PyTree, batch_slots: int,
                 max_seq: int, block: int = 32, kv_quant: bool = False):
        self.cfg = cfg
        self.params = params
        self.b = batch_slots
        self.max_seq = max_seq
        self.device = params["embed"].device
        self.prefill = make_prefill_step(cfg, block_q=block, block_k=block,
                                         kv_quant=kv_quant)
        self.decode = make_decode_step(cfg, kv_quant=kv_quant)
        # Slots not written yet hold zero scales: they dequantize to zero
        # keys, and the position mask hides them anyway.
        self.cache = M.cache_init(cfg, batch_slots, max_seq,
                                  device=self.device, quant=kv_quant)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.pos = 0                  # shared absolute position
        self.tok_shape = ((1, cfg.n_codebooks) if cfg.n_codebooks
                          else (1,))  # one slot's token, less the batch
        self.next_tok = torch.zeros((batch_slots,) + self.tok_shape,
                                    dtype=torch.int32, device=self.device)

    # -- admission ---------------------------------------------------------

    def _splice(self, one: PyTree, idx: int) -> None:
        """Write one request's prefill cache into slot ``idx`` of the
        pool, in place."""
        for site, leaves in self.cache.items():
            axis = M.batch_axis(self.cfg, site)
            for name, pool in leaves.items():
                pool.narrow(axis, idx, 1).copy_(one[site][name])

    def admit(self, req: Request) -> bool:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return False
        idx = free[0]
        plen = req.prompt.shape[0]
        prompt = torch.from_numpy(np.asarray(req.prompt, np.int32)).to(
            self.device)[None]
        logits, cache1 = self.prefill(self.params, prompt)
        cache1 = M.pad_cache(self.cfg, cache1, self.max_seq)
        if self.pos == 0 or not any(s is not None for s in self.slots):
            self.pos = plen
        # Only exact-position admission in lockstep mode: the driver
        # groups same-length prompts per wave.
        if plen != self.pos:
            return False
        self._splice(cache1, idx)
        self.next_tok[idx:idx + 1] = greedy_sample(logits).reshape(
            (1,) + self.tok_shape)
        self.slots[idx] = req
        return True

    # -- one lockstep tick -------------------------------------------------

    def tick(self) -> int:
        if not any(s is not None for s in self.slots):
            return 0
        logits, self.cache = self.decode(self.params, self.cache,
                                         self.next_tok, self.pos)
        tok = greedy_sample(logits).reshape((self.b,) + self.tok_shape)
        self.next_tok = tok
        self.pos += 1
        live = 0
        emitted = tok.cpu().numpy()        # the tick's one host read
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.out.append(emitted[i].ravel().tolist()
                           if self.cfg.n_codebooks else int(emitted[i, 0]))
            if len(req.out) >= req.max_new or self.pos >= self.max_seq:
                req.done = True
                self.slots[i] = None
            else:
                live += 1
        return live

    def run(self, requests: List[Request], max_ticks: int = 10_000
            ) -> List[Request]:
        pending = list(requests)
        ticks = 0
        while (pending or any(self.slots)) and ticks < max_ticks:
            while pending and self.admit(pending[0]):
                pending.pop(0)
            if not any(s is not None for s in self.slots):
                if pending:          # position mismatch: reset the wave
                    self.pos = 0
                    continue
                break
            self.tick()
            ticks += 1
        return requests
