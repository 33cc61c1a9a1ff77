"""The ``--device`` argument every CLI of the port takes.

``--device cuda`` (the default) or ``--device cpu``, also written
``--device=cpu``; the other arguments (a ``--config`` file and
``section.key=value`` overrides, CLI-specific ``key=value`` extras) pass
through in order.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple


def pop_device(argv: Optional[Sequence[str]] = None) -> Tuple[str, List[str]]:
    """(device, the other arguments) of ``argv`` (``sys.argv[1:]`` when
    None).  A ``--device`` with no value raises ValueError."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device, rest = "cuda", []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 == len(argv):
                raise ValueError("--device needs a value (cuda or cpu)")
            device = argv[i + 1]
            i += 1
        elif a.startswith("--device="):
            device = a.partition("=")[2]
        else:
            rest.append(a)
        i += 1
    return device, rest
