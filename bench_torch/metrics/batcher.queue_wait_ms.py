"""Mean wait of a request from submit to its batch's dispatch over the
window (ServingStats), ms."""


def read(run):
    c = run.counters
    if not c.get("rows"):
        return None
    return 1e3 * c["queue_wait_s"] / c["rows"]
