"""idle_pct.audio_rate: the device's idle share of the traced window."""
from h100bench.readers import idle_pct


def read(ctx, run):
    return idle_pct(run)
