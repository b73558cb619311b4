"""Share of its roofline that the ``bal_scores`` kernel
(``csrc/bal_round.cu``'s row and heavy-row kernels) reaches over the
window: the least time of every balancing round's scores (each round's
vertices of overloaded blocks and their arcs, ``bench/roofline.py``),
over the profiler's device time of those kernels, in percent."""

from bench import roofline

KERNELS = ("bal_scores_rows", "bal_scores_heavy_rows")


def read(run):
    if run.events is None or not run.bal_work:
        return None
    least = sum(roofline.least_seconds(*roofline.bal_scores(*w))
                for w in run.bal_work)
    spent = run.kernel_seconds("bal_round", KERNELS)
    return 100.0 * least / spent if spent > 0 else None
