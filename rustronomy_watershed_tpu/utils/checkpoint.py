"""Per-water-level checkpoint / resume for long transforms.

The reference has no checkpointing (SURVEY.md §5: "none; state is
reconstructible per level" via transform_history / per-level PNGs).  This
rebuild makes that explicit: the level loop's carried state is exactly
``(water_level, labels)``, so a transform can be snapshotted every N levels
(orbax) and resumed bit-exactly — useful for very large mosaics or preemptible
jobs.  Active on the host-stepped path via
``TransformBuilder.set_checkpoint(dir, every=N)``.
"""

from __future__ import annotations

import numpy as np


class TransformCheckpointer:
    def __init__(self, directory, every: int = 16):
        import orbax.checkpoint as ocp

        self.every = max(1, int(every))
        self._mgr = ocp.CheckpointManager(str(directory))

    def maybe_save(self, water_level: int, labels: np.ndarray) -> bool:
        """Save at every Nth level (and always at level 0)."""
        if water_level % self.every != 0:
            return False
        import orbax.checkpoint as ocp

        self._mgr.save(
            water_level,
            args=ocp.args.StandardSave(
                {"labels": np.asarray(labels), "water_level": water_level}
            ),
        )
        return True

    def latest(self):
        """(water_level, labels) of the newest snapshot, or None."""
        step = self._mgr.latest_step()
        if step is None:
            return None
        state = self._mgr.restore(step)
        return int(state["water_level"]), np.asarray(state["labels"])

    # -- relax fast-path plane snapshots (ops/ckpt_relax.py) ---------------

    def save_planes(self, calls, L, d, lab, *, meta):
        """Snapshot the relax engine's (L, d, label) planes after a chunk
        call.  The device->host copies start asynchronously first, then the
        host arrays go to orbax's async save, so the transfer overlaps the
        next chunk's compute."""
        import orbax.checkpoint as ocp

        for a in (L, d, lab):
            try:
                a.copy_to_host_async()
            except AttributeError:
                pass  # non-jax array (tests) — np.asarray below just works
        self._mgr.save(
            int(calls),
            args=ocp.args.StandardSave(
                {
                    # (no string "kind" marker — orbax StandardSave rejects
                    # str leaves; latest_planes keys off "lab" instead)
                    "calls": int(calls),
                    "L": np.asarray(L),
                    "d": np.asarray(d),
                    "lab": np.asarray(lab),
                    "meta": [int(m) for m in meta],
                }
            ),
        )
        return True

    def latest_planes(self):
        """Newest relax-plane snapshot as a dict, or None (absent / the
        directory holds per-level snapshots instead)."""
        step = self._mgr.latest_step()
        if step is None:
            return None
        state = self._mgr.restore(step)
        if "lab" not in state:
            return None
        return state

    def wait(self):
        self._mgr.wait_until_finished()
