"""k3_roofline: K3 (the whole batch-1 window in one launch) against its
bound (``work.sampler_work``), its device time from ``scan_kernel``."""
import re

from h100bench import work
from h100bench.readers import roofline

K3 = re.compile(r"\bscan_kernel\b")


def read(ctx, run):
    m = ctx.cell.config["model"]
    return roofline(run, K3, "k3_calls", work.bound_s(*work.sampler_work(T=m["n_diff_steps"], N=m["n_motions"],
                                                                          P=m["n_prev_motions"])))
