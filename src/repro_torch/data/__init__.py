from repro_torch.data.synthetic import make_regression

__all__ = ["make_regression"]
