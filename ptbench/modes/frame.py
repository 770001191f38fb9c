"""A frame cell: progressive path-traced frames of one static view.

Set-up builds the port's RenderSession on the card from the scene
description and renders WARM_FRAMES frames (the first builds the sun grid
and loads the kernels). The window then renders one progressive sample per
frame through `RenderSession.render_frame`, each ended by
`torch.cuda.synchronize()` as the viewer's frame is, from a zero
accumulation resumed at the run's first sample index (`restore_state`).
The check compares the accumulation at pixels drawn from the seed with the
reference's (ptbench/ref/frame.py) over the same samples.
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
        self.first_sample = int(first_sample)
        self.device = device
        self.width, self.height = int(config["width"]), int(config["height"])
        self.session = None
        self.steps = 0
        self.phases = {}

    def setup(self):
        """Builds the session and warms it; `phases` gets the seconds of
        each part: importing the port, packing its scene, the session, the
        first frame (the sun grid's host build) and the other warm frames."""
        t = [time.perf_counter()]
        from dxrpathtracer_tpu_torch.app.session import RenderSession

        from ..port import port_preset, port_scene, port_settings
        t.append(time.perf_counter())
        scene = port_scene(self.desc)
        t.append(time.perf_counter())
        sess = RenderSession(port_settings(self.config), self.width,
                             self.height, device=self.device, scene=scene,
                             preset=port_preset(self.traffic))
        sync(self.device)
        t.append(time.perf_counter())
        for k in range(WARM_FRAMES):
            sess.render_frame()
            sync(self.device)
            if k == 0:
                t.append(time.perf_counter())
        t.append(time.perf_counter())
        self.phases = dict(zip(("port_import", "port_scene", "session",
                                "first_frame", "warm_frames"),
                               np.diff(t).tolist()))
        self.session = sess
        self.restart(self.first_sample)

    def restart(self, first_sample: int):
        """Resume from a zero accumulation at sample `first_sample`."""
        self.session.restore_state({
            "accum": np.zeros((self.height, self.width, 3), np.float32),
            "sample_idx": int(first_sample)})
        sync(self.device)
        self.first_sample, self.steps = int(first_sample), 0

    def step(self):
        self.session.render_frame()
        sync(self.device)
        self.steps += 1

    def setup_readings(self) -> dict:
        return {"sun_grid_build_s": self.session.sun_grid_build_s}

    def rays_per_step(self) -> int:
        """bench.py:94's count: W * H * (1 + (L - 1) * 2)."""
        length = int(self.config["settings"].get("max_path_length", 3))
        return self.width * self.height * (1 + (length - 1) * 2)

    def draw(self, rng, count: int):
        """The pixels compared: `count` row-major indices drawn by `rng`."""
        return np.sort(rng.choice(self.width * self.height, size=count,
                                  replace=False))

    def outputs(self, idx):
        """The accumulation at the pixels `idx`, on the host."""
        acc = self.session.accum.reshape(-1, 3)
        return acc[torch.from_numpy(idx).to(acc.device)].cpu()

    def numbers(self, got, ref) -> dict:
        return {"bad_px_pct": off_pct(got, ref)}

    def release(self):
        self.session = None

    def reference(self, idx, device, storage=torch.float32):
        from ..ref.frame import accumulate
        return accumulate(self.desc, self.config, self.traffic, idx,
                          self.first_sample, self.steps, device, storage)
