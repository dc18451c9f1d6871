from .gaussian import GaussianTransition
from .categorical import (CategoricalTransition, UniformCategoricalTransition,
                          build_transition_mats, build_init_prob)
