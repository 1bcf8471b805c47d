"""Mean host ms a window step spends in the program's ``prepare.input``:
the batch to the device (COO sort, copies) and its labels."""


def read(record):
    spans = record.get("program_spans")
    if not spans or not record["steps"]:
        return None
    busy = sum(e - s for n, t, _, s, e in spans
               if n == "prepare.input" and t == "main" and e is not None)
    return 1e3 * busy / record["steps"]
