"""idle_pct.train_rate: the device's idle share of the traced steps."""
from h100bench.readers import idle_pct


def read(ctx, run):
    return idle_pct(run)
