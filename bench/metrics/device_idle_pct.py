"""Share of the traced window in which no device operation ran (no
kernel, copy or fill), from the profiler's timeline, in percent: how far
the host holds the card back."""

from bench.devtrace import busy_seconds


def read(run):
    if run.events is None:
        return None
    return 100.0 * (1.0 - busy_seconds(run.events) / run.window_s)
