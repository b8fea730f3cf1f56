"""mfu.audio_rate: the model's operations of the traced calls or rounds
(``work.py``) over the traced window at the bf16 peak."""
from h100bench.readers import mfu


def read(ctx, run):
    return mfu(run)
