"""The unbalanced request's share of the card's float32 peak: the
operations of an unbalanced solve (``ugw_counts.solve_ops``: its init,
cost evaluations, Sinkhorn iterations, marginals and penalties) times
``requests_per_s``, over 67 TFLOP/s. Another loss, or a solver without a
support size: nothing is read."""
from portbench import roofline, stats, ugw_counts


def read(ctx):
    rate = stats.rate([r.done_s for r in ctx.records], ctx.start_s,
                      ctx.end_s)
    st = ctx.settings
    if rate is None or "s" not in st or ctx.loss != "l2":
        return None
    ops = ugw_counts.solve_ops(int(st["s"]), ctx.n, int(st["outer_iters"]),
                               int(st["inner_iters"]))
    return 100.0 * rate * ops / roofline.FP32_FLOPS
