"""The sparse convs' roofline time over their device time: per encoder
conv and pass the larger of its operations over the bf16 peak and its
bytes over the memory bandwidth, summed over the window's steps, over
the time of the ``sparse_conv`` kernels."""


def read(record):
    if "conv_roofline_s" not in record or "family_s" not in record:
        return None
    busy = record["family_s"]["sparse_conv"]
    return 100.0 * record["conv_roofline_s"] / busy if busy > 0 else None
