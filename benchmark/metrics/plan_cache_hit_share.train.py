"""Share of the events whose plans the window's batches found in the
plan cache: the change of ``PlanCache.hits`` over hits plus misses."""


def read(record):
    c = record["counters"]
    total = c["plan_cache_hits"] + c["plan_cache_misses"]
    return 100.0 * c["plan_cache_hits"] / total if total else None
