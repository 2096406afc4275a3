"""Training callbacks: hook interface, training state, metrics logging
(counterpart of volsurfs_tpu/training/callbacks.py).

``Trainer.train`` calls ``iter_started`` before a step and ``iter_ended``
after it with the step's losses as 0-d tensors, which may still be on the
card. A callback turns them into numbers only at its own cadence
(``MetricsLoggerCallback`` every ``log_every`` steps), so that no step
waits for the device on the callbacks' account. ``StepTimerCallback``
waits for the device on purpose: it times steps.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


class Callback:
    def training_started(self, **kwargs):
        pass

    def training_ended(self, **kwargs):
        pass

    def epoch_started(self, **kwargs):
        pass

    def epoch_ended(self, **kwargs):
        pass

    def phase_started(self, **kwargs):
        pass

    def phase_ended(self, **kwargs):
        pass

    def iter_started(self, **kwargs):
        pass

    def iter_ended(self, **kwargs):
        pass


class CallbacksGroup(Callback):
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def __getattribute__(self, name):
        if name in (
            "training_started", "training_ended", "epoch_started", "epoch_ended",
            "phase_started", "phase_ended", "iter_started", "iter_ended",
        ):
            def fanout(**kwargs):
                for cb in object.__getattribute__(self, "callbacks"):
                    getattr(cb, name)(**kwargs)

            return fanout
        return object.__getattribute__(self, name)


class StateCallback(Callback):
    """iters/sec tracking."""

    def __init__(self):
        self._t0 = None
        self._iters = 0
        self.iters_per_sec = 0.0

    def training_started(self, **kwargs):
        self._t0 = time.perf_counter()

    def iter_ended(self, **kwargs):
        self._iters += 1
        dt = time.perf_counter() - self._t0
        if dt > 0:
            self.iters_per_sec = self._iters / dt


class MetricsLoggerCallback(Callback):
    """Local scalar logging to ``run_dir/metrics.jsonl`` (losses, extras,
    eval metrics); reads the loss tensors only every ``log_every`` steps."""

    def __init__(self, run_dir: str, log_every: int = 10):
        self.path = os.path.join(run_dir, "metrics.jsonl")
        os.makedirs(run_dir, exist_ok=True)
        self.log_every = log_every
        self._file = open(self.path, "a")

    def iter_ended(self, iter_nr=None, losses=None, extras=None, **kwargs):
        if iter_nr is None or iter_nr % self.log_every != 0:
            return
        rec = {"iter": int(iter_nr)}
        for src, prefix in ((losses, "train/loss_"), (extras, "train/")):
            if src:
                for k, v in src.items():
                    try:
                        rec[prefix + k] = float(v)
                    except (TypeError, ValueError, RuntimeError):
                        pass
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def log_eval(self, split: str, metrics: dict, iter_nr: int):
        rec = {"iter": int(iter_nr)}
        rec.update({f"eval/{split}/{k}": float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def training_ended(self, **kwargs):
        self._file.close()


class StepTimerCallback(Callback):
    """Host-clock time of every step, from ``iter_started`` to the end of
    a ``torch.cuda.synchronize()`` in ``iter_ended`` (on a CPU run, to the
    end of the step's host work), and the step's loss tensors, kept on the
    device until ``losses()`` stacks them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.step_ms = []
        self._loss = []
        self._t = None

    def iter_started(self, **kwargs):
        self._t = time.perf_counter()

    def iter_ended(self, losses=None, **kwargs):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.step_ms.append((time.perf_counter() - self._t) * 1e3)
        self._loss.append(losses["loss"])

    def losses(self) -> np.ndarray:
        return torch.stack(self._loss).cpu().numpy() if self._loss else np.zeros(0)

    def median_ms(self, warmup: int) -> float:
        return float(np.median(self.step_ms[warmup:]))
