from jstsp19.harness.pipeline import PointConfig, realization_errors  # noqa: F401
from jstsp19.harness.runner import run_sweep, SweepResult  # noqa: F401
from jstsp19.harness.experiments import EXPERIMENTS, get_experiment  # noqa: F401
