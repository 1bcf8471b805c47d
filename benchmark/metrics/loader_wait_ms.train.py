"""Mean host ms a window step waits in the program's ``loader.get`` (the
main thread's wait for the loader's queue, inside ``next_args``)."""


def read(record):
    spans = record.get("program_spans")
    if not spans or not record["steps"]:
        return None
    wait = sum(e - s for n, t, _, s, e in spans
               if n == "loader.get" and t == "main" and e is not None)
    return 1e3 * wait / record["steps"]
