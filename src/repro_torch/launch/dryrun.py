"""The serving and training layouts of JAX's dry run
(`repro/launch/dryrun.py`): `_rules_for(cfg, shape_name)`, the rule table
each shape cell lowers under. The port executes these layouts
(`dist.shardings.run_sharded`, `run_prefill`, `run_decode` in a
`dist.mesh_context(mesh, rules=_rules_for(cfg, shape))`).

The rest of the dry run (lowering and compiling each arch x shape x mesh
cell on forced host devices, the cost and memory analysis, the probes) is
ROADMAP Queue 1 item 3: torch has no AOT compile to port it onto.
"""
from __future__ import annotations

from repro_torch import dist


def _rules_for(cfg, shape_name: str) -> dict:
    """The rule table of `shape_name`'s cell: DEFAULT_RULES, the config's
    `rules_override`, then the shape's serving layout:

    - prefill_32k: the KV cache written split by sequence over "model",
      compute head-split;
    - decode_32k: flash decoding: batch over "data", the cache's sequence
      over "model", heads whole in compute, FSDP over "data";
    - long_500k: batch 1: the sequence over "data", heads keep "model",
      no FSDP."""
    rules = dict(dist.DEFAULT_RULES)
    rules.update(cfg.rules_override)
    if shape_name == "prefill_32k":
        rules["seq_kv"] = "model"
        rules["kv_heads"] = None
    if shape_name == "decode_32k":
        rules["seq_kv"] = "model"
        rules["kv_heads"] = None
        rules["heads"] = None
        rules["fsdp"] = "data"
    if shape_name == "long_500k":
        rules["batch"] = None
        rules["seq_kv"] = "data"
        rules["kv_heads"] = None
        rules["fsdp"] = None
    return rules
