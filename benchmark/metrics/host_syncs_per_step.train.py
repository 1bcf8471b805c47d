"""Host syncs a window step (the program's ``host_syncs`` counter: every
synchronizing CUDA operation the host made) inside ``next_args`` and
``step``."""


def read(record):
    spans = record.get("program_spans")
    if not spans or not record["steps"]:
        return None

    def root(i):
        while i >= 0 and spans[i][2] >= 0:
            i = spans[i][2]
        return spans[i][0] if i >= 0 else None

    syncs = sum(n for name, i, n in record.get("program_counters", [])
                if name == "host_syncs" and root(i) in ("next_args", "step"))
    return syncs / record["steps"]
