"""device_idle_pct: the share of the traced window in which no operation
ran on the card (kernels, copies, memsets; their intervals' union).
Nothing when the trace holds no device op."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s()) / tr.window_s
