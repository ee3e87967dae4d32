"""ar_solve_fwd_roofline.likelihood: the least time of the traced test
batch's MADE solves (their flops by solve_flops at the float32 peak; they
are bound by operations, not bytes) over the device time of the forward
kernels that ops/ar_flow.py launches for them, named in
ar_solve_fwd_roofline.likelihood.json, %. Nothing where no such kernel ran."""


def read(r):
    t = r["trace"]
    if t is None:
        return None
    names = r["data"]["kernels"]
    device_s = sum(s for k, s in t["kernel_s"].items() if any(n in k for n in names))
    solve = r["flops"]["solve_per_unit"] * t["units"]
    if device_s <= 0 or solve <= 0:
        return None
    return 100.0 * solve / r["peak_flops"] / device_s
