from repro_torch.data import pipeline
from repro_torch.data.synthetic import make_regression

__all__ = ["make_regression", "pipeline"]
