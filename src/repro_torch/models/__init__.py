from . import registry
from .param import ParamSpec, count_params, init_params

__all__ = ["registry", "ParamSpec", "count_params", "init_params"]
