"""Device ms a window step of the kernels that ``kernels/knn.json`` names
(the dynamic graph CNN's neighbour search, ``csrc/knn.cu``); nothing where
no such kernel ran."""


def read(record):
    family = record.get("family_s", {}).get("knn")
    if not family or not record["steps"]:
        return None
    return 1e3 * family / record["steps"]
