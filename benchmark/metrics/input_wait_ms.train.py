"""Mean host ms a window step spends in the session's ``next_args()``:
the wait for the loader's batch and its preparation on the device."""


def read(record):
    spans = [e - s for n, s, e in record["spans"] if n == "next_args"]
    return 1e3 * sum(spans) / len(spans) if spans else None
