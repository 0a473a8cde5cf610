"""Auto-training schedule: the headless equivalent of the reference UI loop.

The reference drives training from the wx idle handler (src/ui/UiFrame.cpp:
266-298): rate-limited to AUTO_TRAIN_BUDGET steps/s, and BEFORE the step it
checks the current iteration counter — every ``intervalCapture`` iterations
it randomizes all rig rotations and re-captures truth, and every
``intervalDensify`` iterations the step runs with densification.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

from gaussian_splatterer_tpu.train.trainer import Trainer, randomize_rig_rotations


def auto_train(
    trainer: Trainer,
    rtx,
    num_steps: int,
    rng: Optional[random.Random] = None,
    on_step: Optional[Callable[[int, object], None]] = None,
    rate_limit: Optional[float] = None,
    capture_first: bool = True,
    capture_devices=None,
) -> dict:
    """Run ``num_steps`` auto-training iterations.

    rate_limit: max steps/s (None = unthrottled; the reference caps at
    AUTO_TRAIN_BUDGET=100/s purely to keep the UI responsive).
    capture_devices: >1 devices shard every (re)capture over a camera
    mesh (parallel/capture.py).

    Returns the wall-clock split: total_s, capture_s, capture_frac and the
    recapture count.
    """
    import jax

    def _fenced_capture():
        """Capture, fenced with block_until_ready so the accounting
        attributes the capture's device time to capture."""
        t0 = time.perf_counter()
        if capture_devices is not None:
            trainer.capture_truths(rtx, devices=capture_devices)
        else:
            # no kwarg: tests monkeypatch capture_truths with stubs
            trainer.capture_truths(rtx)
        jax.block_until_ready(trainer.truths)
        return time.perf_counter() - t0

    p = trainer.project
    capture_s = 0.0
    t_start = time.perf_counter()
    recaptures = 0
    if capture_first and trainer.truths is None:
        capture_s += _fenced_capture()
    for _ in range(num_steps):
        t0 = time.perf_counter()
        capture = p.intervalCapture > 0 and p.iterations % p.intervalCapture == 0
        densify_now = p.intervalDensify > 0 and p.iterations % p.intervalDensify == 0
        if capture and p.iterations > 0:
            randomize_rig_rotations(p, rng)
            capture_s += _fenced_capture()
            recaptures += 1
        metrics = trainer.train(densify_now=densify_now)
        if on_step is not None:
            on_step(p.iterations, metrics)
        if rate_limit:
            leftover = 1.0 / rate_limit - (time.perf_counter() - t0)
            if leftover > 0:
                time.sleep(leftover)
    total_s = time.perf_counter() - t_start
    return {
        "total_s": round(total_s, 2),
        "capture_s": round(capture_s, 2),
        "capture_frac": round(capture_s / max(total_s, 1e-9), 4),
        "recaptures": recaptures,
    }
