"""mfu.likelihood: the flops of the window's test batches through the
likelihood protocol, counted from the reference's shapes (the MADE solves
by solve_flops), over the window's seconds, as a share of the float32
peak, %."""


def read(r):
    w = r["window"]
    return 100.0 * r["flops"]["per_unit"] * w["units"] / w["seconds"] / r["peak_flops"]
