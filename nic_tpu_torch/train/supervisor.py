"""Crash-resilient training supervisor (counterpart of
nic_tpu/train/supervisor.py).

Training resumes from its latest checkpoint by step and stops exactly at
``last_step``, so a restart is idempotent: the supervisor re-runs the
training command in a fresh process until it exits cleanly or the retries
run out. Activated by ``python -m nic_tpu_torch <model> train ... --retries N``.
"""

import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

_CHILD_ENV = "NIC_TPU_TORCH_TRAIN_CHILD"


def supervise(argv: List[str], retries: int, backoff_secs: float = 10.0) -> int:
    """Run ``python -m nic_tpu_torch <argv>`` up to ``retries + 1`` times,
    resuming from the latest checkpoint on each attempt. Returns the final
    exit code.

    SIGTERM and SIGINT are forwarded to the running child and end the retry
    loop, so that a wrapper that signals only the supervisor leaves no
    training child holding the card.
    """
    env = dict(os.environ, **{_CHILD_ENV: "1"})
    cmd = [sys.executable, "-m", "nic_tpu_torch", *argv]
    child: List[Optional[subprocess.Popen]] = [None]
    stop = [False]

    def _forward(signum, frame):
        stop[0] = True
        if child[0] is not None and child[0].poll() is None:
            child[0].terminate()

    prev_term = signal.signal(signal.SIGTERM, _forward)
    prev_int = signal.signal(signal.SIGINT, _forward)
    try:
        rc = 1
        for attempt in range(retries + 1):
            if stop[0]:
                print("[supervisor] stopping on signal", file=sys.stderr)
                return 143
            if attempt:
                print(
                    f"[supervisor] attempt {attempt + 1}/{retries + 1} "
                    f"(previous exit code {rc}); resuming from latest checkpoint",
                    file=sys.stderr,
                )
                time.sleep(backoff_secs)
            child[0] = subprocess.Popen(cmd, env=env)
            rc = child[0].wait()
            if rc == 0:
                return 0
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)
    print(
        f"[supervisor] training failed after {retries + 1} attempts "
        f"(last exit code {rc})",
        file=sys.stderr,
    )
    return rc


def is_supervised_child() -> bool:
    return bool(os.environ.get(_CHILD_ENV))
