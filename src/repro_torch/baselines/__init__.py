"""Reference solvers of the penalized Elastic Net (the front end's oracles)."""
from repro_torch.baselines.coordinate_descent import CDResult, cd_path, elastic_net_cd
from repro_torch.baselines.fista import FistaResult, elastic_net_fista

__all__ = ["CDResult", "FistaResult", "cd_path", "elastic_net_cd", "elastic_net_fista"]
