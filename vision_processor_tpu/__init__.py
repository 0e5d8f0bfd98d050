"""vision-processor-tpu: real-time RoboCup SSL vision pipeline in JAX.

Public surface:

* ``app.main``            — the vision_processor camera loop (CLI)
* ``app.processor``       — Processor: per-camera device step + host finishing
* ``ops.pipeline``        — BlobMachine: the jitted frame -> blobs graph
* ``models.detector``     — in-graph robot/ball hypothesis search
* ``parallel.multicam``   — camera batching + shard_map mesh scale-out
* ``calib.geometry``      — camera auto-calibration
* ``net.udp``             — SSL multicast bus (vision / game controller)
* ``io.camera``           — camera driver registry

Heavy modules import jax lazily; importing this package is cheap.
"""

__version__ = "0.1.0"

__all__ = [
    "app",
    "calib",
    "io",
    "models",
    "net",
    "ops",
    "parallel",
    "proto",
    "utils",
]
