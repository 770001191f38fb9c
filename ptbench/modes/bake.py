"""A bake cell: progressive steps of the GI lightmap bake.

Set-up builds the port's RenderSession (8x8: the bake renders no frame)
and its Baker on the configuration's atlas at its resolution, and bakes
WARM_STEPS steps (the first builds the sun grid and loads the kernels). The
window then runs `Baker.bake_step` (one sample for every covered texel,
slab by slab), each ended by `torch.cuda.synchronize()`, from a zero
accumulation at the run's first sample index. The check compares the
accumulation [colorSum | validCount] at texels drawn from the seed with the
reference's (ptbench/ref/bake.py) over the same steps.
"""

import time

import numpy as np
import torch

from ..check import off_pct
from ..trace import sync

STEP = "bake"  # a step is one bake sample of every covered texel
WARM_STEPS = 2


class Runner:
    unit_name = "steps"

    def __init__(self, config, traffic, desc, first_sample, device):
        self.config, self.traffic, self.desc = config, traffic, desc
        self.first_sample = int(first_sample)
        self.device = device
        self.resolution = int(config["resolution"])
        self.session = self.baker = None
        self.steps = 0
        self.phases = {}

    def setup(self):
        """Builds the session and the Baker and warms them; `phases` gets
        the seconds of each part: importing the port, packing its scene,
        the session, the Baker (the texel map and surface maps), the first
        step (the sun grid's host build) and the other warm step."""
        t = [time.perf_counter()]
        from dxrpathtracer_tpu_torch.app.session import RenderSession
        from dxrpathtracer_tpu_torch.bake.baker import Baker

        from ..port import port_preset, port_scene, port_settings
        t.append(time.perf_counter())
        scene = port_scene(self.desc)
        t.append(time.perf_counter())
        sess = RenderSession(port_settings(self.config), 8, 8,
                             device=self.device, scene=scene,
                             preset=port_preset(self.traffic))
        sync(self.device)
        t.append(time.perf_counter())
        baker = Baker(sess, resolution=self.resolution,
                      atlas_mode=self.config["atlas"])
        sync(self.device)
        t.append(time.perf_counter())
        for k in range(WARM_STEPS):
            baker.bake_step()
            sync(self.device)
            if k == 0:
                t.append(time.perf_counter())
        t.append(time.perf_counter())
        self.phases = dict(zip(("port_import", "port_scene", "session",
                                "baker", "first_step", "warm_steps"),
                               np.diff(t).tolist()))
        self.session, self.baker = sess, baker
        self.restart(self.first_sample)

    def restart(self, first_sample: int):
        """Start from a zero accumulation at sample `first_sample`."""
        self.baker.accum.zero_()
        self.baker.sample_index = int(first_sample)
        sync(self.device)
        self.first_sample, self.steps = int(first_sample), 0

    def step(self):
        self.baker.bake_step()
        sync(self.device)
        self.steps += 1

    def setup_readings(self) -> dict:
        return {"sun_grid_build_s": self.session.sun_grid_build_s,
                "texel_map_s": self.baker.setup_s["texel_map"]}

    def rays_per_step(self) -> int:
        """bench.py:94's count over the covered texels."""
        length = int(self.config["settings"].get("max_path_length", 3))
        covered = int((self.baker.surface_maps["position"][..., 3] > 0)
                      .sum().item())
        return covered * (1 + (length - 1) * 2)

    def draw(self, rng, count: int):
        """The texels compared: `count` flat indices drawn by `rng`."""
        res = self.resolution
        return np.sort(rng.choice(res * res, size=count, replace=False))

    def outputs(self, idx):
        """[colorSum | validCount] at the texels `idx`, on the host."""
        acc = self.baker.accum.reshape(-1, 4)
        return acc[torch.from_numpy(idx).to(acc.device)].cpu()

    def numbers(self, got, ref) -> dict:
        lm = lambda a: a[:, :3] / a[:, 3:4].clamp_min(1.0)  # noqa: E731
        return {"bad_texel_pct": off_pct(lm(got.double()), lm(ref.double()),
                                         got[:, 3] != ref[:, 3])}

    def release(self):
        self.session = self.baker = None

    def reference(self, idx, device, storage=torch.float32):
        from ..ref.bake import lightmap
        return lightmap(self.desc, self.config, self.traffic, idx,
                        self.first_sample, self.steps, device, storage)
