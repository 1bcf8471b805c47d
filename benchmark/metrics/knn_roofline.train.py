"""The neighbour search's roofline time over its device time: per stage
the larger of its operations (2 P^2 F a cloud) over the card's float32
peak and its bytes over the memory bandwidth, summed over the window's
steps (the model family's ``knn_roofline_s``), over the time of the
``knn`` kernels."""


def read(record):
    busy = record.get("family_s", {}).get("knn")
    if "knn_roofline_s" not in record or not busy:
        return None
    return 100.0 * record["knn_roofline_s"] / busy
