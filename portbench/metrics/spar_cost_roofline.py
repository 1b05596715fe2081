"""Share of the cost kernels' roofline: the least time of the cost
evaluations of the requests answered in the traced rounds over the
device time of the kernels that ran them.

The kernels are found by name: K1, the materialized matvec
(``csrc/spar_matvec.cu``), and K2, the gather-fused cost
(``csrc/spar_cost_fused.cu``). Each request makes ``outer_iters + 1``
evaluations, each of least time ``roofline.cost_eval_s`` (l2: the two
n x n cost matrices read once, 8 n² bytes at 3.35 TB/s, against 4 s n
float32 operations at 67 TFLOP/s; the bytes bound both cells). A filler
lane of a flush is no request: its work counts against the share. No
launch of these names in the rounds, another loss, or a solver without a
support size: nothing is read.
"""
from portbench import roofline

KERNELS = ("spar_matvec_kernel", "spar_cost_rows_kernel",
           "spar_cost_global_kernel")


def read(ctx):
    t, st = ctx.trace, ctx.settings
    if t is None or not t.requests or "s" not in st or ctx.loss != "l2":
        return None
    launches, seconds = t.time_of(KERNELS)
    if not launches or seconds <= 0:
        return None
    least = (t.requests * (int(st["outer_iters"]) + 1)
             * roofline.cost_eval_s(int(st["s"]), ctx.n))
    return 100.0 * least / seconds
