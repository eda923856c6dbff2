"""Serving entry points of the port: the Elastic Net engine (the LM half of
`repro/serve` waits for the port of the LM workload)."""
from repro_torch.serve.engine import ElasticNetEngine, EngineStats, EnResult

__all__ = [
    "ElasticNetEngine",
    "EngineStats",
    "EnResult",
]
