"""Device ms a window step of every kernel outside the kernel families:
norms, elementwise glue, loss, optimizer, sorts, copies on the device."""


def read(record):
    if "family_s" not in record or not record["steps"]:
        return None
    return 1e3 * record["family_s"]["other"] / record["steps"]
