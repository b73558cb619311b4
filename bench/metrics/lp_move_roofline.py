"""Share of its roofline that the ``lp_move`` kernel (``csrc/lp_move.cu``,
its heavy-row form included) reaches over the window: the least time of
every LP-move pass the window's clustering calls made
(``bench/roofline.py``: each level's rows and arcs, once an iteration),
over the profiler's device time of the source's kernels, in percent."""

from bench import roofline


def read(run):
    if run.events is None or not run.lp_work:
        return None
    least = sum(it * roofline.least_seconds(*roofline.lp_move(n, m))
                for n, m, it in run.lp_work)
    spent = run.kernel_seconds("lp_move")
    return 100.0 * least / spent if spent > 0 else None
