"""Sustained App soak on the GPU: a moving robot tracked over 80 frames
through the production loop (pipelined), detections on the wire.

    python experiments/soak_app.py
"""
import sys, threading, time, tempfile
from pathlib import Path

import numpy as np
import yaml

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vision_processor_tpu.models.camera import CameraModel
from vision_processor_tpu.net.geometry_io import geometry_from_dict
from vision_processor_tpu.net.udp import UDPSocket
from vision_processor_tpu.app.main import App
from vision_processor_tpu.io.camera import SyntheticDriver, register_driver
from vision_processor_tpu.io.synthetic import Scene, SceneBall, SceneBot
from vision_processor_tpu.proto import SSL_WrapperPacket

N_FRAMES = 80
FPS = 50.0

field_cfg = {
    "field": {
        "field_length": 9000, "field_width": 6000, "goal_width": 1000,
        "goal_depth": 180, "goal_height": 160, "penalty_area_depth": 1000,
        "penalty_area_width": 2000, "goal_center_to_penalty_mark": 6000,
        "boundary_width": 300, "boundary_width_goal_line": 300,
        "center_circle_radius": 500, "line_thickness": 10,
        "ball_radius": 21.5, "max_robot_radius": 90.0,
    }
}
geometry = geometry_from_dict(field_cfg)
model = CameraModel(
    focal_length=900.0, principal_point=np.array([480.0, 360.0]),
    distortion_k2=0.02, pos=np.array([-2250.0, 0.0, 4500.0]),
    size=np.array([960, 720]),
)
geometry.geometry.ClearField("calib")
geometry.geometry.calib.append(model.to_proto(0))

group, port = "224.99.99.51", 17601
tmp = Path(tempfile.mkdtemp())
config = {
    "cam_id": 0,
    "bot_heights_file": str(tmp / "heights.yml"),
    "camera": {"driver": "SYNTHETIC"},
    "network": {"vision_ip": group, "vision_port": port,
                "gc_ip": "224.99.99.52", "gc_port": 17602},
    "stream": {"active": False},
    "debug": {"wait_for_geometry": True},
    "thresholds": {"blobs": 128},
}
(tmp / "config.yml").write_text(yaml.dump(config))
(tmp / "heights.yml").write_text(yaml.dump({"TeamA": 143.0, "TeamB": 147.0}))

# robot 9 walks a diagonal at 800 mm/s; ball stays put
def animate(scene, t):
    scene.bots[0].x = -3200.0 + 800.0 * t
    scene.bots[0].y = -800.0 + 500.0 * t
    scene.bots[0].orientation = 0.5 + 0.4 * t

scene = Scene(
    bots=[SceneBot(9, "yellow", -3200.0, -800.0, 0.5)],
    balls=[SceneBall(-1200.0, 900.0)],
    noise_sigma=1.5,
)
register_driver(
    "SYNTHETIC",
    lambda cam_cfg: SyntheticDriver(
        model, geometry.geometry.field, scene, fmt="RGGB", fps=FPS,
        frames=N_FRAMES, animate=animate,
    ),
)

sender = type("S", (UDPSocket,), {"_parse": lambda self, d: None})(group, port)
stop = threading.Event()
def publish():
    while not stop.is_set():
        sender.send(geometry)
        time.sleep(0.05)
threading.Thread(target=publish, daemon=True).start()

received = []
class Recorder(UDPSocket):
    def _parse(self, data):
        w = SSL_WrapperPacket()
        w.ParseFromString(data)
        if w.HasField("detection"):
            received.append(w.detection)

recorder = Recorder(group, port)
try:
    app = App(str(tmp / "config.yml"))
    app.run()
    time.sleep(0.5)
finally:
    stop.set()
    recorder.close()
    sender.close()

assert len(received) == N_FRAMES, f"got {len(received)}/{N_FRAMES} frames"
missed, max_err = 0, 0.0
for det in received:
    t = det.t_capture - 1.0 / FPS  # frame rendered at (idx)/fps, idx from 0
    ex = -3200.0 + 800.0 * t
    ey = -800.0 + 500.0 * t
    bots = [b for b in det.robots_yellow if b.robot_id == 9]
    if not bots:
        missed += 1
        continue
    err = min(np.hypot(b.x - ex, b.y - ey) for b in bots)
    max_err = max(max_err, err)
assert missed == 0, f"robot 9 missing in {missed} frames"
assert max_err < 40.0, f"max tracking error {max_err:.1f} mm"
balls_ok = sum(1 for det in received
               if det.balls and abs(det.balls[0].x - -1200.0) < 40)
assert balls_ok >= N_FRAMES - 1, balls_ok
print(f"SOAK OK: {N_FRAMES} frames, robot 9 tracked every frame, "
      f"max position error {max_err:.1f} mm, ball in {balls_ok} frames")
