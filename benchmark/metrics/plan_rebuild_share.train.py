"""Share of the batches the loader assembled in the window whose plans
the planner built a second time with widened lists: the change of
``HostPlanner.widened`` over the batches assembled."""


def read(record):
    c = record["counters"]
    n = c["batches_assembled"]
    return 100.0 * c["plans_widened"] / n if n else None
