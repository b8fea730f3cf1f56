"""mfu.train_rate: the model's operations of the traced steps
(``work.train_step_flops``) over the traced window at the bf16 peak."""
from h100bench.readers import mfu


def read(ctx, run):
    return mfu(run)
