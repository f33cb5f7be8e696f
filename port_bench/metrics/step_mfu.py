"""The whole step's share (%) of the card's bf16 peak: the step's
products (counts.step_flops, products only) times the window's steps,
over the untraced window, over 989 TFLOP/s."""

from port_bench import counts


def read(r):
    if not r.step_s:
        return None
    flops = counts.step_flops(r.config, r.traffic) * r.window_steps
    return 100.0 * flops / r.window_s / counts.BF16_FLOP_PER_S
