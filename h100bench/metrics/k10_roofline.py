"""k10_roofline: K10 (WavLM's gated relative-position attention, one
forward call an encoder layer and one backward call a trained layer)
against the bound of the traced steps' calls (``wavlm_work.k10_bound_s``
over the query rows the mode read from K10's counters), its device time
from the kernels of ``csrc/relpos_attn.cu`` by name. None where the run
made no K10 call (a program without K10)."""
import re

from h100bench import wavlm_work

K10 = re.compile(r"\bk10_relpos_(fwd|bwd_pre|bwd_dkdv|bwd_dq|bwd_dr)\b")


def read(ctx, run):
    fwd, bwd = run.work.get("k10_fwd_rows", 0), run.work.get("k10_bwd_rows", 0)
    t = run.tracer
    if t is None or not (fwd or bwd):
        return None
    device_s = t.kernel_s(K10)
    if device_s <= 0:
        return None
    arch = ctx.cell.config["audio"]
    L = 2 * ctx.cell.config["model"]["n_motions"]
    bound = wavlm_work.k10_bound_s(fwd, bwd, L, arch["num_heads"], arch["hidden_size"] // arch["num_heads"])
    return 100.0 * bound / device_s
