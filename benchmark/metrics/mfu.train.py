"""Useful operations of the events the window trained (each conv's
matched pairs x Cin x Cout x 2, x3 for forward, dX and dW, and the 1x1
bottleneck) over the window's seconds, as a share of the card's dense
bf16 peak."""


def read(record):
    if "useful_flop" not in record:
        return None
    rate = record["useful_flop"] / record["window_s"]
    return 100.0 * rate / record["peak"]["bf16_flops"]
