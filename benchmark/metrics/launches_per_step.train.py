"""launches_per_step.train: the device operations (kernels, copies, fills)
of the traced train steps, over those steps."""


def read(r):
    t = r["trace"]
    return None if t is None or not t["units"] else t["launches"] / t["units"]
