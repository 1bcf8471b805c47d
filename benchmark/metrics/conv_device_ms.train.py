"""Device ms a window step of the kernels that
``kernels/sparse_conv.json`` names (the CUDA functions of the program's
``csrc/``)."""


def read(record):
    if "family_s" not in record or not record["steps"]:
        return None
    return 1e3 * record["family_s"]["sparse_conv"] / record["steps"]
