"""The share of the traced window in which no kernel, copy or memset ran on
the card, in %."""


def read(summary):
    if summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
