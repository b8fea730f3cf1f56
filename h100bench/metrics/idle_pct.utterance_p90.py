"""idle_pct.utterance_p90: the device's idle share of the traced window."""
from h100bench.readers import idle_pct


def read(ctx, run):
    return idle_pct(run)
