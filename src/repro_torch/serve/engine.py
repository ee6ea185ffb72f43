"""Serving request record.

Counterpart of `repro/serve/engine.py:32` (`Request`).  The host-loop
`ServeEngine` comes with a later slice; the jit-resident engine of
`serve/jit_engine.py` consumes these records.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
