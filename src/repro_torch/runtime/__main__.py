"""`python -m repro_torch.runtime` — the serving-load smoke (loadgen CLI)."""
from repro_torch.runtime.loadgen import main

main()
