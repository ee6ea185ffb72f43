"""The kernel wrappers' launch counters, read and advanced as one set.

Each wrapper adds one to its module's counter where it launches its
kernel.  A CUDA graph launches its kernels at every replay but runs the
wrappers only while it is captured, when nothing is launched: the
engine (`serve/jit_engine.py`) takes the counters' change over the
capture as the graph's launches, takes it back, and adds it at every
replay, so the counters keep counting launches.
"""

from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.kernels import flash_attention, nbbs_alloc, paged_attention

Counts = Dict[Tuple[str, str], int]

_SCALARS = (
    (nbbs_alloc, ("launches", "slab_launches", "wavefront_step_launches",
                  "wavefront_alloc_launches")),
    (paged_attention, ("launches",)),
    (flash_attention, ("launches",)),
)


def launch_counts() -> Counts:
    """Every launch counter, keyed by (module, name); the tier counts of
    kernels A, 3 and 4 as ("nbbs_alloc", "tier_launches/<tier>")."""
    out = {(mod.__name__.rsplit(".", 1)[1], name): getattr(mod, name)
           for mod, names in _SCALARS for name in names}
    for where, n in nbbs_alloc.tier_launches.items():
        out[("nbbs_alloc", f"tier_launches/{where}")] = n
    return out


def since(before: Counts) -> Counts:
    """The launches counted after `before` was read."""
    now = launch_counts()
    return {k: now[k] - before.get(k, 0) for k in now}


def add(delta: Counts, times: int = 1) -> None:
    """Advance every counter by `times` x its entry in `delta`."""
    mods = {mod.__name__.rsplit(".", 1)[1]: mod for mod, _ in _SCALARS}
    for (mod, name), n in delta.items():
        if name.startswith("tier_launches/"):
            nbbs_alloc.tier_launches[name.split("/", 1)[1]] += n * times
        else:
            m = mods[mod]
            setattr(m, name, getattr(m, name) + n * times)
