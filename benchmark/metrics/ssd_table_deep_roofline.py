"""Kernel ssd_table_deep (csrc/me_ssd.cu ssd_table_deep_kernel<SIZE, ...>,
9-14-bit samples): the least time of its launches in the window over
their profiled device time, in percent; three int8 products counted."""
from benchmark.harness import roofline, trace


def read(ctx):
    ev = trace.kernel_events(ctx["profile"],
                             r"ssd_table_deep_kernel<(\d+), false")
    bound = sum(roofline.bound_s(*roofline.ssd_cost(ctx, int(m.group(1)),
                                                    True),
                                 roofline.INT8_TC_OPS) for m, _ in ev)
    return roofline.share(bound, sum(t for _, t in ev)) if ev else None
