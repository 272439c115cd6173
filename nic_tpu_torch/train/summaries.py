"""Training observability (counterpart of nic_tpu/train/summaries.py):
metrics as JSON lines and TensorBoard summaries, a throughput meter and a
torch.profiler trace.

``metrics.jsonl`` gets one line per logged step, ``{"step": N, <metric>:
value, ...}``, as nic_tpu writes it. Given a ``logdir``, and when
``torch.utils.tensorboard`` imports (it needs the tensorboard package), the
writer also writes a TensorBoard event file there with nic_tpu's tags and
steps: each metric as a scalar, and the original and reconstruction images
in the format of TensorFlow 2's ``tf.summary.image`` (one summary per name
holding up to ``max_outputs`` PNGs, pixels converted as
``tf.image.convert_image_dtype`` converts them). Without the package it
keeps the JSON lines only, which is what nic_tpu does when tensorflow
cannot be imported.
"""

import contextlib
import io
import json
import os
import time
from typing import Dict, Optional

import numpy as np


def _image_summary(tag: str, images: np.ndarray):
    """A Summary proto of ``images`` [N, H, W, C] in [0, 1] as TensorFlow 2's
    image summary writes it: a string tensor [width, height, png...]."""
    from PIL import Image
    from tensorboard.compat.proto.summary_pb2 import Summary
    from tensorboard.compat.proto.tensor_pb2 import TensorProto
    from tensorboard.compat.proto.tensor_shape_pb2 import TensorShapeProto
    from tensorboard.plugins.image.metadata import create_summary_metadata

    # convert_image_dtype(float -> uint8, saturate=True): x * 255.5, truncated.
    pixels = np.minimum(images * np.float32(255.5), 255).astype(np.uint8)
    pngs = []
    for img in pixels:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "PNG")
        pngs.append(buf.getvalue())
    values = [str(images.shape[2]).encode(), str(images.shape[1]).encode()] + pngs
    tensor = TensorProto(dtype=7,  # DT_STRING
                         tensor_shape=TensorShapeProto(
                             dim=[TensorShapeProto.Dim(size=len(values))]),
                         string_val=values)
    return Summary(value=[Summary.Value(
        tag=tag, tensor=tensor,
        metadata=create_summary_metadata(display_name=None, description=None))])


class SummaryWriter:
    def __init__(self, jsonl_path: str, logdir: Optional[str] = None):
        self.jsonl_path = jsonl_path
        self._tb = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter as TensorBoardWriter
            except ImportError:  # no tensorboard package: JSON lines only
                pass
            else:
                self._tb = TensorBoardWriter(logdir)

    def write(self, step: int, metrics: Dict[str, float]):
        record = {"step": step}
        record.update({k: float(v) for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), global_step=step)
            self._tb.flush()

    def write_images(self, step: int, images: Dict[str, np.ndarray], max_outputs: int = 2):
        """Original/reconstruction image summaries, [N, H, W, 3] floats
        clipped to [0, 1], the first ``max_outputs`` of each. TensorBoard
        only: without a TensorBoard logdir nothing is written."""
        if self._tb is None:
            return
        writer = self._tb._get_file_writer()
        for name, img in images.items():
            img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
            writer.add_summary(_image_summary(name, img[:max_outputs]), step)
        self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()


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
