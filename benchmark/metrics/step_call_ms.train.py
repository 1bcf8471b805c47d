"""Mean host ms a window step spends in the session's ``step()``: the
dispatch of forward, backward and optimizer, and the step's own syncs."""


def read(record):
    spans = [e - s for n, s, e in record["spans"] if n == "step"]
    return 1e3 * sum(spans) / len(spans) if spans else None
