"""Reference solvers of the penalized Elastic Net (the front end's oracles)."""
from repro_torch.baselines.coordinate_descent import CDResult, cd_path, elastic_net_cd
from repro_torch.baselines.fista import FistaResult, elastic_net_fista
from repro_torch.baselines.shotgun import ShotgunResult, elastic_net_shotgun

__all__ = ["CDResult", "FistaResult", "ShotgunResult", "cd_path", "elastic_net_cd",
           "elastic_net_fista", "elastic_net_shotgun"]
