"""Seconds the process's first ``make_optimizer`` call took (``torch.optim.Adam``
loads ``torch._dynamo``), as the program records it in
``posendf_torch.utils.profiling.SETUP_S``; None where the program keeps no
such record."""

import sys


def read(w):
    prof = sys.modules.get("posendf_torch.utils.profiling")
    return getattr(prof, "SETUP_S", {}).get("make_optimizer")
