"""Training observability (counterpart of nic_tpu/train/summaries.py):
metrics as JSON lines, a throughput meter and a torch.profiler trace.

``metrics.jsonl`` gets one line per logged step, ``{"step": N, <metric>:
value, ...}``, as nic_tpu writes it. TensorBoard events are not written:
with a ``logdir`` the writer does what nic_tpu's does when tensorflow
cannot be imported, which is to keep the JSON lines only and drop the
scalars and images.
"""

import contextlib
import json
import os
import time
from typing import Dict, Optional


class SummaryWriter:
    def __init__(self, jsonl_path: str, logdir: Optional[str] = None):
        self.jsonl_path = jsonl_path
        self.logdir = logdir

    def write(self, step: int, metrics: Dict[str, float]):
        record = {"step": step}
        record.update({k: float(v) for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def write_images(self, step: int, images, max_outputs: int = 2):
        """Original/reconstruction image summaries: TensorBoard only, so
        nothing is written."""


class ThroughputMeter:
    """Images/sec and steps/sec since the meter started (or was reset)."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._images = 0
        self._steps = 0

    def update(self, batch_images: int, steps: int = 1):
        self._images += batch_images
        self._steps += steps

    def rates(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "images_per_sec": self._images / dt,
            "steps_per_sec": self._steps / dt,
        }

    def reset(self):
        self._t0 = time.perf_counter()
        self._images = 0
        self._steps = 0


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """torch.profiler trace of the block (host and, with a card, device
    activity) written to ``<logdir>/trace.json`` as a Chrome trace; no-op
    when logdir is falsy."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
