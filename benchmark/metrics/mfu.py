"""The whole parse's share of the card's bfloat16 peak: the FLOPs that the
window's screenshots need (the benchmark's own formulas: per screenshot
the detector and the text detector, per candidate line the recogniser, per
needed caption the captioner), over the window times the peak."""


def read(run):
    if not run["flops"] or run["window_s"] <= 0:
        return None
    return 100.0 * run["flops"] / (run["window_s"] * run["peaks"]["bf16_flops"])
