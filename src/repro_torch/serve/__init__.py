"""LM serving of the port (counterpart of ``repro.serve``): the prefill
and decode step factories, the int8 KV cache's decision (``engine``) and
the lockstep slot server (``driver``)."""

from repro_torch.serve.driver import BatchedServer, Request
from repro_torch.serve.engine import (auto_kv_quant, decode_tokens_abstract,
                                      greedy_sample, make_decode_step,
                                      make_prefill_step)

__all__ = ["BatchedServer", "Request", "auto_kv_quant",
           "decode_tokens_abstract", "greedy_sample", "make_decode_step",
           "make_prefill_step"]
