"""Closed-loop QoS control plane: slack-driven knob plans + energy governor
(port of ``repro.control``).

Sits between serving telemetry (``serving.deadline``) and the compute path
(``core.pipeline`` / ``kernels.ops``): the
:class:`~repro_torch.control.governor.Governor` turns projected deadline
slack, queue depth and an EWMA of modeled window energy into a
:class:`~repro_torch.control.plan.KnobPlan` (D' cap, bit-slice precision,
tau offsets) that the engine latches on the host per dispatched step
(``StreamEngine.set_plan``).
"""
from .governor import (Governor, GovernorPolicy, build_ladder,
                       ladder_rel_cost, plan_level, policy_for,
                       policy_from_env)
from .plan import KnobPlan, full_plan

__all__ = [
    "Governor", "GovernorPolicy", "KnobPlan", "build_ladder", "full_plan",
    "ladder_rel_cost", "plan_level", "policy_for", "policy_from_env",
]
