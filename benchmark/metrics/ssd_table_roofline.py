"""Kernel ssd_table (csrc/me_ssd.cu ssd_table_kernel<SIZE>, 8-bit): the
least time of its launches in the window over their profiled device
time, in percent. Operations and bytes from the cell's grid shapes."""
from benchmark.harness import roofline, trace


def read(ctx):
    ev = trace.kernel_events(ctx["profile"], r"ssd_table_kernel<(\d+)>")
    bound = sum(roofline.bound_s(*roofline.ssd_cost(ctx, int(m.group(1)),
                                                    False),
                                 roofline.INT8_TC_OPS) for m, _ in ev)
    return roofline.share(bound, sum(t for _, t in ev)) if ev else None
