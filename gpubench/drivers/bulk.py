"""Driver of the offline mixes: `DetectorServer.bulk_detect` jobs of
job_images distinct model-sized images each, back to back on the caller's
thread, at the server's largest bucket. Only whole jobs count, and no job
starts after the window's length has passed.

Set-up draws pool_images host images and the weights from the seed and
builds the server without its bucket warm-up (the jobs use the largest
bucket alone); the warm-up runs jobs. Job j's images are the pool in the
permutation drawn from (seed, j)."""

from __future__ import annotations

import time
import torch

from gpubench import common
from gpubench.drivers import detection, program


class Cell:
    def __init__(self, spec: dict, seed: int, device, run_program: bool = True):
        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        t = spec["traffic"]
        self.t = t
        self.pool = common.host_images(seed, range(t["pool_images"]), spec["config"]["image_size"])
        self.jobs = 0
        if run_program:
            self.srv = detection.server(spec, seed, self.device, warmup=False, autostart=False)

    def _job(self):
        g = common.rng(self.seed, common.TAG_ORDER, self.jobs)
        order = g.permutation(len(self.pool))[:self.t["job_images"]]
        self.jobs += 1
        return order, self.srv.bulk_detect([self.pool[i] for i in order])

    def warm(self):
        self._job()

    def window(self, seconds: float, marks: bool) -> dict:
        program.sync(self.device)
        t0, self.done = time.perf_counter(), []
        while time.perf_counter() - t0 < seconds:
            self.done.append(self._job())
        wall = time.perf_counter() - t0
        images = sum(len(o) for o, _ in self.done)
        return {"attempted": images, "failed": 0, "wall_s": wall,
                "e2e": {"bulk_img_per_s": images / wall}}

    def traced(self, seconds: float, trace) -> dict:
        images = 0
        with trace:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                with torch.profiler.record_function("gpubench.bulk_job"):
                    images += len(self._job()[0])
        return {"images": images, "computed_images": images,
                "attn_fwd_layers": self.spec["config"]["num_hidden_layers"]}

    def free(self):
        self.srv.close()
        del self.srv
        program.free()

    def _sample(self, n: int) -> list:
        g = common.rng(self.seed, common.TAG_SAMPLE)
        pairs = [(o[k], r[k]) for o, r in self.done for k in range(len(o))]
        return [pairs[i] for i in sorted(g.choice(len(pairs), min(n, len(pairs)), replace=False))]

    def check(self) -> dict:
        served = self._sample(self.t["check_images"])
        return detection.check(self.spec, self.seed, self.device, self.pool, served)

    def control(self) -> dict:
        g = common.rng(self.seed, common.TAG_SAMPLE)
        idx = sorted(g.choice(len(self.pool), self.t["check_images"], replace=False))
        return detection.control(self.spec, self.seed, self.device, self.pool, idx)
