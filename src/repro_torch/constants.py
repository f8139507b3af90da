"""Shared numeric constants for the id encoding.

One module, no dependencies beyond numpy, importable from both
``repro_torch.kernels`` and ``repro_torch.core`` (which must not import
each other's internals just to agree on a sentinel).

The join machinery encodes "no row here" as ``INT32_MAX``
in key columns (it sorts last and a searchsorted probe can never equal
it) and ``-1`` in payload/row padding.  That is only sound because real
vertex ids are far below the sentinel: the documented bound is
``MAX_VERTEX_ID`` (ids fit in 21 bits, the headroom the 42-bit pair-key
analysis assumes).  ``RDFGraph`` enforces the bound at
construction time, so a graph whose ids could collide with the sentinel
is rejected loudly instead of silently corrupting semijoin masks.
"""
from __future__ import annotations

import numpy as np

#: pad/fill sentinel for key columns: sorts after every real id, never
#: equals one (ids are bounded by MAX_VERTEX_ID).
INT32_SENTINEL: int = int(np.iinfo(np.int32).max)

#: inclusive upper bound on vertex ids (2^21 - 1).  Leaves the sentinel
#: (and the whole upper int32 range) unreachable by real data.
MAX_VERTEX_ID: int = (1 << 21) - 1

#: inclusive upper bound on property ids.  Properties are a small label
#: space; the same 21-bit bound keeps every id well clear of INT32_MAX
#: (property keys share the masked-key encoding in the edge tables).
MAX_PROPERTY_ID: int = (1 << 21) - 1
