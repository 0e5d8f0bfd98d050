"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding paths can
be exercised without a GPU. Must set env vars before jax import. Tests
marked ``gpu`` need the card and skip elsewhere; run them there with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's platform is the GPU (decided here, never at
    import, so every xdist worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def divb_field():
    """Division-B field geometry proto (9x6 m)."""
    from vision_processor_tpu.net.geometry_io import geometry_from_dict

    cfg = {
        "field": {
            "field_length": 9000,
            "field_width": 6000,
            "goal_width": 1000,
            "goal_depth": 180,
            "goal_height": 160,
            "penalty_area_depth": 1000,
            "penalty_area_width": 2000,
            "goal_center_to_penalty_mark": 6000,
            "boundary_width": 300,
            "boundary_width_goal_line": 300,
            "center_circle_radius": 500,
            "line_thickness": 10,
            "ball_radius": 21.5,
            "max_robot_radius": 90.0,
        }
    }
    return geometry_from_dict(cfg)


@pytest.fixture(scope="session")
def overhead_model():
    """A camera 4.5 m above midfield of one half, looking straight down-ish."""
    from vision_processor_tpu.models.camera import CameraModel

    model = CameraModel(
        focal_length=900.0,
        principal_point=np.array([480.0, 360.0]),
        distortion_k2=0.02,
        pos=np.array([-2250.0, 0.0, 4500.0]),
        size=np.array([960, 720]),
    )
    return model
