"""Device operations (kernels, copies, memsets) the trace records over the
solves completed in the traced window."""


def read(summary):
    if not summary["solves"] or not summary["ops"]:
        return None
    return len(summary["ops"]) / summary["solves"]
