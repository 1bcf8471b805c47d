"""Mean host ms a window step spends in the program's
``prepare.plans_copy``: the batch's host plans copied to the device."""


def read(record):
    spans = record.get("program_spans")
    if not spans or not record["steps"]:
        return None
    busy = sum(e - s for n, t, _, s, e in spans
               if n == "prepare.plans_copy" and t == "main" and e is not None)
    return 1e3 * busy / record["steps"]
