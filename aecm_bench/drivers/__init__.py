"""The drives that a traffic file names (`drive`): step.py, run.py."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def steps_called():
    """The program's compiled steps (CompiledStep) that the block calls, by
    id: what the cell itself replays, whose capture_seconds set-up paid."""
    from webrtc_aecm_tpu_torch.compiled import CompiledStep
    seen = {}
    call = CompiledStep.__call__

    def spy(self, *args):
        seen[id(self)] = self
        return call(self, *args)
    CompiledStep.__call__ = spy
    try:
        yield seen
    finally:
        CompiledStep.__call__ = call


def capture_seconds(steps: dict) -> float:
    return float(sum(s.capture_seconds for s in steps.values()))
