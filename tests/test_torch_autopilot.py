"""The port's fleet autopilot against the JAX package's.

Every scenario of ``tests/test_autopilot.py`` (respawn to the min pool,
quarantine of a flapping replica under back-off, scale on queue depth
and on the p99 trend, shrink, the degraded-link hold, retune and canary
with rollback, predictive scale, the decision events) runs through
``apex_tpu.serving.autopilot.FleetAutopilot`` and through the port's,
over the same scripted fake fleet and injected clock, with its own
asserts on each side; the two give the same decision log, requests and
router counters (``fleet_twins.py``).
"""

import pytest

import fleet_twins as tw
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", tw.cases("test_autopilot"))
def test_autopilot_scenario_matches_reference(case, tmp_path):
    out = tw.assert_same("test_autopilot", case, tmp_path)
    assert set(out) >= {"decisions", "requests", "counters"}
