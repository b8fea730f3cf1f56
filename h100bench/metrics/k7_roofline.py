"""k7_roofline: K7 (the training FFN block, forward and backward, one
call each a decoder layer a step) against the bound of both at the step's
rows (``work.ffn_train_work``), its device time from the kernels of
``csrc/ffn_train.cu`` and ``csrc/gemm_train.cuh`` by name."""
import re

from h100bench import work
from h100bench.readers import roofline

K7 = re.compile(r"\b(gemm_train_kernel|tgemm_kernel|ln_fwd_kernel|ln_bwd_kernel|colsum_partial_kernel"
                r"|colsum_final_kernel|mask_bits_kernel|ffn_reduce_kernel)\b")


def read(ctx, run):
    rows = run.work["k7_rows"]
    bound = work.bound_s(*work.ffn_train_work(rows)) + work.bound_s(*work.ffn_train_work(rows, backward=True))
    return roofline(run, K7, "k7_calls", bound)
