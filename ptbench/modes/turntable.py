"""A turntable cell: displayed frames of a turning scene whose BVH is
rebuilt on the card every frame (the port's `animate` command).

Set-up builds the port's RenderSession on the card from the scene
description as the frame mode does, makes the port's turntable of it
(`scene.animate.Turntable`: the unturned scene, the axis point and the
LBVH plan of its triangle count) and renders WARM_FRAMES displayed frames
from the turn's first (the first loads the kernels). A step is one call
of `Turntable.frame` for the next frame of the turn, which turns the
scene, builds its W8 table on the card, switches the session to both
(`use_geometry`), renders the configuration's samples a frame and
tone-maps the display image, ended by `torch.cuda.synchronize()`. The
turn starts at frame first_sample mod frames_per_turn, so the seed picks
the starting angle. The check compares the accumulation of the last
displayed frame (its samples 0 .. spp - 1, at its angle) at pixels drawn
from the seed with the reference's (ptbench/ref/turntable.py).
"""

import time

import numpy as np
import torch

from ..check import off_pct
from ..trace import sync

STEP = "frame"  # a step is one displayed frame
WARM_FRAMES = 3


class Runner:
    unit_name = "frames"

    def __init__(self, config, traffic, desc, first_sample, device):
        self.config, self.traffic, self.desc = config, traffic, desc
        self.device = device
        self.width, self.height = int(config["width"]), int(config["height"])
        turn = config["turntable"]
        self.frames_per_turn = int(turn["frames_per_turn"])
        self.spp = int(turn["samples_per_frame"])
        self.turn = None
        self.phases = {}
        self.restart(first_sample)

    def setup(self):
        """Builds the session and its turntable and warms them; `phases`
        gets the seconds of each part: importing the port, packing its
        scene, the session, the turntable (its LBVH plan), the first
        displayed frame and the other warm frames."""
        t = [time.perf_counter()]
        from dxrpathtracer_tpu_torch.app.session import RenderSession
        from dxrpathtracer_tpu_torch.scene.animate import Turntable

        from ..port import port_preset, port_scene, port_settings
        t.append(time.perf_counter())
        scene = port_scene(self.desc)
        t.append(time.perf_counter())
        sess = RenderSession(port_settings(self.config), self.width,
                             self.height, device=self.device, scene=scene,
                             preset=port_preset(self.traffic))
        sync(self.device)
        t.append(time.perf_counter())
        turn = Turntable(sess, self.frames_per_turn)
        t.append(time.perf_counter())
        for k in range(WARM_FRAMES):
            turn.frame((self.first_frame + k) % self.frames_per_turn,
                       self.spp)
            sync(self.device)
            if k == 0:
                t.append(time.perf_counter())
        t.append(time.perf_counter())
        self.phases = dict(zip(("port_import", "port_scene", "session",
                                "plan", "first_frame", "warm_frames"),
                               np.diff(t).tolist()))
        self.turn = turn

    def restart(self, first_sample: int):
        """Start the turn again at frame first_sample mod frames_per_turn."""
        self.first_sample = int(first_sample)
        self.first_frame = self.first_sample % self.frames_per_turn
        self.steps = 0

    def last_frame(self) -> int:
        """The turn's frame that the last step displayed."""
        return (self.first_frame + self.steps - 1) % self.frames_per_turn

    def step(self):
        f = (self.first_frame + self.steps) % self.frames_per_turn
        self.turn.frame(f, self.spp)
        sync(self.device)
        self.steps += 1

    def setup_readings(self) -> dict:
        return {}

    def rays_per_step(self) -> int:
        """bench.py:94's count a sample, W * H * (1 + (L - 1) * 2), times
        the samples a displayed frame."""
        length = int(self.config["settings"].get("max_path_length", 3))
        return self.spp * self.width * self.height * (1 + (length - 1) * 2)

    def draw(self, rng, count: int):
        """The pixels compared: `count` row-major indices drawn by `rng`."""
        return np.sort(rng.choice(self.width * self.height, size=count,
                                  replace=False))

    def outputs(self, idx):
        """The last displayed frame's accumulation at the pixels `idx`, on
        the host."""
        acc = self.turn.session.accum.reshape(-1, 3)
        return acc[torch.from_numpy(idx).to(acc.device)].cpu()

    def numbers(self, got, ref) -> dict:
        return {"bad_px_pct": off_pct(got, ref)}

    def release(self):
        self.turn = None

    def reference(self, idx, device, storage=torch.float32):
        from ..ref.turntable import accumulate
        return accumulate(self.desc, self.config, self.traffic, idx,
                          self.last_frame(), device, storage)
