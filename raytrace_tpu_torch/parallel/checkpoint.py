"""Elastic sample-accumulator checkpoint/resume.

The port's copy of ``raytrace_tpu/parallel/checkpoint.py`` (numpy only;
the port imports nothing of the JAX package). The reference has no
mid-render persistence: renders are all-or-nothing. Monte Carlo
accumulation is associative, so the accumulator persists (pixel radiance
sum, samples done, seed) and resumes by adding more samples - also the
elastic-recovery story: a host that dies loses nothing already flushed,
and a restarted job continues from the last accumulator.

File format: a plain .npz with a schema version, the JAX package's
(``SCHEMA_VERSION`` 1): either package reads the other's accumulator.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
from typing import Optional

import numpy as np

SCHEMA_VERSION = 1


@dataclasses.dataclass
class Accumulator:
    """Running per-pixel radiance sum over completed samples."""

    radiance_sum: np.ndarray  # (H,W,3) float64 host accumulator
    samples_done: int
    width: int
    height: int
    seed: int

    @classmethod
    def zeros(cls, width: int, height: int, seed: int = 0) -> "Accumulator":
        return cls(radiance_sum=np.zeros((height, width, 3), np.float64),
                   samples_done=0, width=width, height=height, seed=seed)

    def mean(self) -> np.ndarray:
        """Current image estimate, (H,W,3) float32 linear radiance."""
        n = max(1, self.samples_done)
        return (self.radiance_sum / n).astype(np.float32)

    def add(self, band_mean: np.ndarray, n_samples: int) -> None:
        """Fold in a full-image render averaged over `n_samples` samples."""
        self.radiance_sum += band_mean.astype(np.float64) * n_samples
        self.samples_done += n_samples

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """Atomic write (tmp + rename) so a crash mid-save keeps the old
        checkpoint valid - the property graceful.go's ordered cleanup was
        after."""
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, version=SCHEMA_VERSION,
                         radiance_sum=self.radiance_sum,
                         samples_done=self.samples_done,
                         width=self.width, height=self.height,
                         seed=self.seed)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def load(cls, path: str) -> "Accumulator":
        with np.load(path) as z:
            if int(z["version"]) != SCHEMA_VERSION:
                raise ValueError(f"checkpoint schema {int(z['version'])} "
                                 f"!= {SCHEMA_VERSION}")
            return cls(radiance_sum=z["radiance_sum"],
                       samples_done=int(z["samples_done"]),
                       width=int(z["width"]), height=int(z["height"]),
                       seed=int(z["seed"]))


def render_with_checkpoints(renderer, scene, width: int, height: int, *,
                            total_samples: Optional[int] = None,
                            samples_per_round: int = 10,
                            checkpoint_path: Optional[str] = None,
                            resume: bool = True) -> np.ndarray:
    """Checkpointed render loop: rounds of `samples_per_round` samples.

    Each round renders with a distinct seed offset (sample ids are globally
    unique across rounds via the seed stream), flushes the accumulator, and
    continues. Interrupting between rounds loses at most one round.
    Returns the mean linear radiance (H,W,3) float32.
    """
    total = total_samples or renderer.samples
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        acc = Accumulator.load(checkpoint_path)
        if (acc.width, acc.height) != (width, height):
            raise ValueError("checkpoint resolution mismatch")
    else:
        acc = Accumulator.zeros(width, height, renderer.seed)

    saved_samples = renderer.samples
    try:
        while acc.samples_done < total:
            n = min(samples_per_round, total - acc.samples_done)
            renderer.samples = n
            # Distinct sample ids per round: shift the seed by the round
            # start so (pixel, sample, seed) draws never repeat.
            renderer.seed = acc.seed + acc.samples_done
            band = renderer.render_linear(scene, width, height)
            acc.add(band, n)
            if checkpoint_path:
                acc.save(checkpoint_path)
    finally:
        renderer.samples = saved_samples
        renderer.seed = acc.seed
    return acc.mean()


class ResourceManager:
    """Named-resource close-all (graceful.go:130-208, working form).

    Resources register a close() callable under a name; close_all runs
    them newest-first collecting errors instead of aborting."""

    def __init__(self):
        self._resources = []  # (name, closer)

    def register(self, name: str, closer) -> None:
        self._resources.append((name, closer))

    def close(self, name: str):
        errs = []
        keep = []
        for n, c in self._resources:
            if n == name:
                try:
                    c()
                except Exception as e:
                    errs.append((n, e))
            else:
                keep.append((n, c))
        self._resources = keep
        return errs

    def close_all(self):
        errs = []
        for name, closer in reversed(self._resources):
            try:
                closer()
            except Exception as e:
                errs.append((name, e))
        self._resources = []
        return errs


class ContextShutdown:
    """Parallel shutdown funcs with error collection (graceful.go:210-295).

    Runs all registered shutdown callables concurrently with a deadline;
    returns the list of (name, error) failures (empty = clean)."""

    def __init__(self, timeout: float = 10.0):
        self.timeout = timeout
        self._funcs = []

    def register(self, name: str, fn) -> None:
        self._funcs.append((name, fn))

    def shutdown(self):
        import concurrent.futures as cf
        errs = []
        with cf.ThreadPoolExecutor(max_workers=max(1, len(self._funcs))) \
                as ex:
            futs = {ex.submit(fn): name for name, fn in self._funcs}
            done, pending = cf.wait(futs, timeout=self.timeout)
            for f in done:
                exc = f.exception()
                if exc is not None:
                    errs.append((futs[f], exc))
            for f in pending:
                errs.append((futs[f], TimeoutError("shutdown timeout")))
                f.cancel()
        return errs


class SignalHandler:
    """signal -> action map (graceful.go:297-344, working form)."""

    def __init__(self):
        self._actions = {}
        self._prev = {}

    def register(self, signum, action) -> None:
        self._actions[signum] = action
        self._prev[signum] = signal.signal(
            signum, lambda s, frame: self._actions[s]())

    def uninstall(self) -> None:
        for signum, prev in self._prev.items():
            signal.signal(signum, prev)
        self._prev.clear()
        self._actions.clear()


class GracefulShutdown:
    """Signal-driven ordered cleanup (graceful.go:35-118, working form).

    Registers SIGINT/SIGTERM handlers that run cleanup callbacks (newest
    first, like the reference's ordered list) - typically an accumulator
    flush - then restores previous handlers.
    """

    def __init__(self):
        self._cleanups = []
        self._prev = {}
        self._installed = False
        self.triggered = False

    def register(self, name: str, fn) -> None:
        self._cleanups.append((name, fn))

    def _handler(self, signum, frame):
        self.triggered = True
        for name, fn in reversed(self._cleanups):
            try:
                fn()
            except Exception as e:  # cleanup errors are reported, not fatal
                print(f"cleanup {name!r} failed: {e}")
        self.uninstall()
        raise KeyboardInterrupt(f"signal {signum}")

    def install(self) -> "GracefulShutdown":
        for sig in (signal.SIGINT, signal.SIGTERM):
            self._prev[sig] = signal.signal(sig, self._handler)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)
            self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
