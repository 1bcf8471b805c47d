"""The whole step's share of the card's float32 peak: the useful
operations of the window's events at that peak (the model family's
``useful_fp32_s``: each layer's forward, dX and dW, the neighbour search
once) over the window's seconds."""


def read(record):
    if "useful_fp32_s" not in record:
        return None
    return 100.0 * record["useful_fp32_s"] / record["window_s"]
