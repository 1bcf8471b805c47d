"""Mean host ms a window step spends in the program's ``step.forward``:
the host's dispatch of the forward, and the syncs it makes."""


def read(record):
    spans = record.get("program_spans")
    if not spans or not record["steps"]:
        return None
    busy = sum(e - s for n, t, _, s, e in spans
               if n == "step.forward" and t == "main" and e is not None)
    return 1e3 * busy / record["steps"]
