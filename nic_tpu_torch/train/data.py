"""Training input: glob -> decode -> random crop -> batch
(counterpart of nic_tpu/train/data.py).

Two pipelines with the same sampling, a uniform choice of image and a
uniform crop of ``patchsize``, both giving uint8 [B, P, P, 3] batches (the
trainer scales them to [0, 1] on the device):
- ``PatchPipeline``: worker threads decode PNG or ``.npy`` files on the
  host, with a decoded-image cache, and prefetch numpy batches;
- ``DeviceDataset``: a uniformly sized corpus held on the device as one
  uint8 tensor, with crops sampled there from a device ``torch.Generator``,
  so a step moves no image bytes from the host.
"""

import glob as globlib
import queue
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch


class PatchPipeline:
    """Infinite stream of [B, P, P, 3] uint8 numpy batches."""

    def __init__(
        self,
        train_glob: str,
        batchsize: int = 8,
        patchsize: int = 256,
        num_threads: int = 8,
        prefetch: int = 32,
        seed: int = 0,
        cache_bytes: int = 2 << 30,
    ):
        self.files: List[str] = sorted(globlib.glob(train_glob))
        if not self.files:
            raise RuntimeError(f"No training images found with glob '{train_glob}'.")
        self.batchsize = batchsize
        self.patchsize = patchsize
        self.seed = seed
        # Decoded images (uint8) up to cache_bytes: a small corpus is decoded
        # once, after which a batch is a copy and a crop.
        self._cache: dict = {}
        self._cache_bytes_left = int(cache_bytes)
        self._cache_lock = threading.Lock()
        self._queue: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True)
            for i in range(num_threads)
        ]
        for t in self._threads:
            t.start()

    def _load(self, path: str) -> Optional[np.ndarray]:
        cached = self._cache.get(path)
        if cached is not None:
            return cached
        img = _decode_image(path)
        if img is None:
            return None
        with self._cache_lock:
            if self._cache_bytes_left >= img.nbytes and path not in self._cache:
                self._cache[path] = img
                self._cache_bytes_left -= img.nbytes
        return img

    def _random_crop(self, img: np.ndarray, rng: np.random.Generator) -> Optional[np.ndarray]:
        p = self.patchsize
        h, w = img.shape[:2]
        if h < p or w < p:
            return None
        i = rng.integers(0, h - p + 1)
        j = rng.integers(0, w - p + 1)
        return img[i : i + p, j : j + p, :]

    def _worker(self, worker_id: int):
        # Seeded with the (seed, worker) pair, not their sum, so that two
        # pipelines with nearby seeds draw no common stream.
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, worker_id]))
        while not self._stop.is_set():
            batch = []
            while len(batch) < self.batchsize:
                img = self._load(self.files[rng.integers(0, len(self.files))])
                if img is None:
                    continue
                crop = self._random_crop(img, rng)
                if crop is not None:
                    batch.append(crop)
            out = np.stack(batch)
            while not self._stop.is_set():
                try:
                    self._queue.put(out, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        return self._queue.get()

    def close(self):
        self._stop.set()


class DeviceDataset:
    """The whole corpus on ``device``, crops sampled there.

    Needs uniformly sized images (use ``PatchPipeline`` for a mixed corpus).
    ``sample(k)`` returns a (k, B, P, P, 3) uint8 tensor on the device: k
    steps' batches, each image and crop drawn uniformly from the dataset's
    own generator, seeded with ``seed``. Under data parallelism every rank
    holds the whole corpus and draws the global batch alike, and keeps the
    ``rank``-th of ``world_size`` equal slices: B = batchsize / world_size.
    """

    def __init__(self, train_glob: str, batchsize: int = 8, patchsize: int = 256,
                 seed: int = 0, device="cuda", rank: int = 0, world_size: int = 1):
        if batchsize % world_size:
            raise ValueError(f"batch size {batchsize} does not split over {world_size} ranks")
        files = sorted(globlib.glob(train_glob))
        if not files:
            raise RuntimeError(f"No training images found with glob '{train_glob}'.")
        imgs = []
        for path in files:
            img = _decode_image(path)
            if img is not None and img.shape[0] >= patchsize and img.shape[1] >= patchsize:
                imgs.append(img)
        if not imgs:
            raise RuntimeError(f"No images >= patchsize {patchsize} under '{train_glob}'.")
        shapes = {im.shape for im in imgs}
        if len(shapes) != 1:
            raise ValueError(
                f"DeviceDataset needs uniformly-sized images, got {shapes}; "
                "use the host PatchPipeline for mixed-size corpora."
            )
        stack = np.stack(imgs)
        self.num_images = stack.shape[0]
        self.nbytes = stack.nbytes
        self.batchsize = batchsize
        self.patchsize = patchsize
        local = batchsize // world_size
        self._slice = slice(rank * local, (rank + 1) * local)
        self.device = torch.device(device)
        self._images = torch.from_numpy(stack).to(self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._offsets = torch.arange(patchsize, device=self.device)

    def sample(self, k: int) -> torch.Tensor:
        """(k, B, P, P, 3) uint8 batches for k steps, on the device."""
        n, h, w, _ = self._images.shape
        size = (k, self.batchsize)
        opts = dict(generator=self._generator, device=self.device)
        idx = torch.randint(0, n, size, **opts)[:, self._slice]
        top = torch.randint(0, h - self.patchsize + 1, size, **opts)[:, self._slice]
        left = torch.randint(0, w - self.patchsize + 1, size, **opts)[:, self._slice]
        rows = (top[..., None] + self._offsets)[..., :, None]
        cols = (left[..., None] + self._offsets)[..., None, :]
        return self._images[idx[..., None, None], rows, cols]

    def close(self):
        self._images = None


def _decode_image(path: str) -> Optional[np.ndarray]:
    """uint8 HWC decode of a PNG/JPEG/.npy file (None on failure)."""
    try:
        if path.endswith(".npy"):
            arr = np.load(path)
            if arr.dtype != np.uint8:
                arr = np.clip(
                    arr * (255.0 if arr.max() <= 1.5 else 1.0), 0, 255
                ).astype(np.uint8)
            return arr
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"), np.uint8)
    except (OSError, ValueError):
        return None
