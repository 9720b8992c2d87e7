"""Architecture registry: one config per assigned architecture (+ torr_edge).

``get(name)`` returns the full published config; ``get_smoke(name)`` returns
a reduced same-family config for CPU smoke tests.
"""
from .registry import (ARCHS, SHAPES, SUBQUADRATIC, TensorSpec, get,
                       get_smoke, input_specs, shape_for)
from .torr_edge import rt_budget_s, torr_edge, torr_edge_no_reuse

__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC", "TensorSpec", "get",
           "get_smoke", "input_specs", "shape_for", "rt_budget_s",
           "torr_edge", "torr_edge_no_reuse"]
