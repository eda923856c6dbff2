"""The LM of the port: layers, attention and the model assembly
(`repro/models/`), for the dense-attention family; the MoE, SSM and MLA
modules hold their configuration types only."""
