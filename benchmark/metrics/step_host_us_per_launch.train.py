"""Host us of the program's ``step`` over the device operations launched
under it: the host's cost of one launch in the step's dispatch."""


def read(record):
    spans, launches = record.get("program_spans"), record.get("span_launches")
    if not spans or not launches:
        return None
    n = sum(v for k, v in launches.items()
            if k == "step" or k.startswith("step/"))
    host = sum(e - s for name, t, _, s, e in spans
               if name == "step" and t == "main" and e is not None)
    return 1e6 * host / n if n else None
