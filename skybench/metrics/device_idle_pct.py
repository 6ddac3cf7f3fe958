"""1 - the union of the intervals in which a kernel, a copy or a set ran
on a card over the traced windows' wall, in percent; the mean of the
cards the cell uses."""


def read(run):
    # no device operation in the window: nothing was measured on a card
    if run.trace is None or run.trace["busy_s"] <= 0 or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
