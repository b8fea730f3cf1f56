"""useful_frames_pct.audio_rate: the share of the frames the sampler ran
that the program handed back, over the run (set-up and window): 100 x the
port's counter ``msmd.frames.kept`` over ``msmd.frames.sampled``
(``msmd_tpu_torch/utils/profiling.py``). Padding of a last window and a
round's empty slots are sampled and not kept. None where the port keeps
no such counters."""


def read(ctx, run):
    try:
        from msmd_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    sampled = c.get("msmd.frames.sampled", 0)
    return 100.0 * c.get("msmd.frames.kept", 0) / sampled if sampled else None
