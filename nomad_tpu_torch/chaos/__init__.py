"""Scenario matrix + fault injection.

Import-light on purpose: server/worker/swim import `chaos.faults` for
their hook points, so this package must never import the server tree
at module load. The matrix/scenario halves (which DO build servers)
load lazily through `run_matrix`/`list_scenarios`.
"""

from . import faults  # noqa: F401  (the hook-point half)


def run_matrix(*args, **kwargs):
    from .matrix import run_matrix as _run
    return _run(*args, **kwargs)


def list_scenarios():
    from .scenarios import SCENARIOS
    return list(SCENARIOS)
