"""Serving entry points of the port: the LM's prefill / decode step
builders and greedy generation, and the Elastic Net engine."""
from repro_torch.serve.engine import (ElasticNetEngine, EngineStats, EnResult,
                                      greedy_generate, make_decode_step,
                                      make_prefill_step)

__all__ = [
    "ElasticNetEngine",
    "EngineStats",
    "EnResult",
    "make_decode_step",
    "make_prefill_step",
    "greedy_generate",
]
