"""Examples of the port, the twins of the repository's `examples/`
(`python -m repro_torch.examples.<name>`).  Each runs on the card unless
it is given `--device cpu`; nothing falls back from the card to the CPU."""

import torch


def resolve_device(name) -> torch.device:
    """The device an example runs on; `cuda` without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch sees no CUDA device here; "
                           "pass --device cpu to run on the CPU")
    return dev
