"""The ``--device`` argument every CLI of the port takes.

``--device cuda`` (the default) or ``--device cpu``, also written
``--device=cpu``; the other arguments (a ``--config`` file and
``section.key=value`` overrides, CLI-specific ``key=value`` extras) pass
through in order.  The CLIs that run on a mesh (``build_ivf``,
``gen_doc_embeddings``, ``test_retrieval``, ``serve``, ``train_retrieval``) take
:func:`device_mesh` of it: ``cuda`` is every visible card, as the JAX
CLIs' ``make_mesh()`` takes every device; ``cuda:N`` or ``cpu`` one slot.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

from haconvdr_torch.device import resolve_device
from haconvdr_torch.parallel.mesh import Mesh, make_mesh


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


def device_mesh(device: str) -> Mesh:
    """The mesh a CLI runs on: every visible card for a bare ``cuda``
    (raising without one), else one slot of the named device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh()
    return make_mesh(devices=[dev])
