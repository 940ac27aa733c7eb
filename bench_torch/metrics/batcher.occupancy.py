"""Real rows per dispatched batch over max_batch, in the window
(ServingStats), %."""


def read(run):
    c = run.counters
    if not c.get("batches"):
        return None
    return 100.0 * c["rows"] / c["batches"] / c["max_batch"]
