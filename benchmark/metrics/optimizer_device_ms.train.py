"""Device ms a window step of the operations launched under the
program's ``step.optimizer`` and its children (``span_device_s``)."""

SPAN = "step/step.optimizer"


def read(record):
    by_span = record.get("span_device_s")
    if not by_span or not record["steps"]:
        return None
    s = sum(v for k, v in by_span.items()
            if k == SPAN or k.startswith(SPAN + "/"))
    return 1e3 * s / record["steps"]
