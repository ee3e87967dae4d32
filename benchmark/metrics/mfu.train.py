"""mfu.train: the flops of the window's train steps, counted from the
reference's shapes, over the window's seconds, as a share of the float32
peak, %."""


def read(r):
    w = r["window"]
    return 100.0 * r["flops"]["per_unit"] * w["units"] / w["seconds"] / r["peak_flops"]
