"""CPU-mesh mirror of the driver's multichip handoff dry run: a robot
crossing from camera 0's area into camera 1's must be matched through the
TRACKED path on camera 1, seeded purely by the per-frame all_gather
tracking exchange over the device mesh (the analogue of the
reference's multicast tracking input, reference src/udpsocket.cpp:204-256).
"""
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def test_tracked_handoff_across_cameras():
    devices = jax.devices()
    if len(devices) < 2:
        pytest.skip("needs >= 2 (virtual) devices")
    from __graft_entry__ import run_handoff_check

    run_handoff_check(devices[:2])


def test_tracked_handoff_eight_devices():
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    from __graft_entry__ import run_handoff_check

    run_handoff_check(devices[:8])
