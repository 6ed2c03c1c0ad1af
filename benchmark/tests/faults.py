"""Faults planted underneath a run, one function each; the harness calls
the one a test names first in every rank (``opts["patch"]``)."""


def state_unchanged():
    """The slice loop returns the probes it was given."""
    from pyslice_tpu_torch.engine import pipeline
    pipeline.multislice = lambda psi, *a, **k: psi


def half_batch():
    """Every second frame is left out: its exit waves are the frame's
    before, so the job's statistics run over half its frames."""
    from pyslice_tpu_torch.engine import pipeline
    inner, last = pipeline.frame_exit_waves, {}

    def frame(positions, probes, spec):
        n = last["n"] = last.get("n", -1) + 1
        if n % 2 == 0:
            last["k"] = inner(positions, probes, spec)
        return last["k"]
    pipeline.frame_exit_waves = frame


def half_block():
    """Every second frame of a stream is marked seen but never folded."""
    from pyslice_tpu_torch.engine.streaming import StreamingTACAW
    inner, calls = StreamingTACAW._fold_frame, [0]

    def fold_frame(self, positions, phases):
        calls[0] += 1
        if calls[0] % 2:
            inner(self, positions, phases)
    StreamingTACAW._fold_frame = fold_frame


def exchange_left_out():
    """The frame-to-kx all_to_all returns what it was given."""
    from pyslice_tpu_torch.parallel import sharded
    sharded.all_to_all = lambda t, group: t.contiguous().clone()


def answer_altered():
    """Every third frame's exit waves come out 1% too large (so every
    job, and every rank's share of it, has one)."""
    from pyslice_tpu_torch.engine import pipeline
    inner, calls = pipeline.frame_exit_waves, [0]

    def frame(positions, probes, spec):
        calls[0] += 1
        k = inner(positions, probes, spec)
        return k * 1.01 if calls[0] % 3 == 2 else k
    pipeline.frame_exit_waves = frame


def fold_altered():
    """One probe chunk of one frame is folded 1% too large."""
    from pyslice_tpu_torch.engine import streaming
    inner, calls = streaming.fold, [0]

    def fold(acc, mean, psi, phases):
        calls[0] += 1
        inner(acc, mean, psi * 1.01 if calls[0] == 3 else psi, phases)
    streaming.fold = fold

