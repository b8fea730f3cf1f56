"""mfu.utterance_p90: the model's operations of the traced utterances
(``work.py``) over the traced window at the bf16 peak."""
from h100bench.readers import mfu


def read(ctx, run):
    return mfu(run)
