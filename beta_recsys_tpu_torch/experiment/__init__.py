"""The run layer: the hyperparameter grid and the datasets x models runner."""

from .experiment import Experiment  # noqa: F401
from .tune import expand_grid, tune  # noqa: F401
