"""k1_roofline: K1 per-entry (the decoder stack, one call a sampling
step) against its bound at the cell's entries (``work.decoder_work``),
its device time from the kernels of ``csrc/decoder.cu``'s per-entry
route by name."""
import re

from h100bench import work
from h100bench.readers import roofline

K1 = re.compile(r"\b(cast_kernel|gemm_sm90_kernel|gemm_kernel|self_attn_kernel|person_attn_kernel|ln_person_kernel"
                r"|ln_kernel)\b")


def read(ctx, run):
    lq = 1 + ctx.cell.config["model"]["n_prev_motions"] + ctx.cell.config["model"]["n_motions"]
    return roofline(run, K1, "k1_calls", work.bound_s(*work.decoder_work(run.work["k1_be"], lq)))
