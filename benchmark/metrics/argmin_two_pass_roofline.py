"""Kernel argmin_two_pass (csrc/me_ssd.cu argmin_two_pass_kernel): the
least time of its launches in the window over their profiled device time,
in percent. Its name does not carry the grid, so its launches take the
grids in the proportion of the SSD-table launches of the window."""
from benchmark.harness import roofline, trace


def read(ctx):
    ev = trace.kernel_events(ctx["profile"], r"argmin_two_pass_kernel")
    tables = trace.kernel_events(ctx["profile"],
                                 r"ssd_table(?:_deep)?_kernel<(\d+)")
    if not ev or not tables:
        return None
    sizes = [int(m.group(1)) for m, _ in tables]
    per = sum(roofline.bound_s(*roofline.argmin_cost(ctx, sz),
                               roofline.SCALAR32_OPS) for sz in sizes)
    bound = per / len(sizes) * len(ev)
    return roofline.share(bound, sum(t for _, t in ev))
