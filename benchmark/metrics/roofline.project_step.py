"""``posendf_project_step``: its least time (``costs``) over its mean device time, in %.

The three field entry points launch one kernel symbol, ``field_kernel<Act, Bf16>``;
the projection cells launch it only in the projection-step mode.
"""

from benchmark import costs, readers

KERNEL = "field_kernel<"


def read(w):
    poses = int(w.traffic["batch"])
    least = costs.least_seconds(costs.project_step_flops(w.spec, poses),
                                costs.project_step_bytes(w.spec, poses))
    return readers.roofline(w, lambda n: KERNEL in n, lambda n: KERNEL in n, least)
