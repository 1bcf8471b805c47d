"""Share of the window in which the loader's thread was busy: its
``loader.assemble`` and ``plans.build`` spans, cut to the window."""


def read(record):
    spans = record.get("program_spans")
    if not spans:
        return None
    w = record["window_s"]
    busy = sum(min(w if e is None else e, w) - max(s, 0.0)
               for n, t, _, s, e in spans
               if n in ("loader.assemble", "plans.build") and t != "main")
    return 100.0 * max(busy, 0.0) / w
