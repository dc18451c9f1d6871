from .misc import seed_all, load_yaml, save_yaml, load_json, save_json
from .profiling import profile_trace, StepTimer

__all__ = ["seed_all", "load_yaml", "save_yaml", "load_json", "save_json",
           "profile_trace", "StepTimer"]
