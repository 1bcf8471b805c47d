"""Mean host ms of the program's ``plans.build`` (cache lookup, the build
of the misses and the join) over the batches whose plans the window
built, each ended inside it."""


def read(record):
    spans = record.get("program_spans")
    if not spans:
        return None
    builds = [e - s for n, _, _, s, e in spans
              if n == "plans.build" and e is not None
              and s >= 0.0 and e <= record["window_s"]]
    return 1e3 * sum(builds) / len(builds) if builds else None
