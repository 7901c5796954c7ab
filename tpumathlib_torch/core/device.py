"""The port's one default device.

Where the port makes a tensor with no tensor to follow (a host array
turned into a container, a carried reference object, a generator's words,
``Handle()``), it places it on ``default_device()``: the CUDA card. There is
no test of whether a card is present, so on a machine without one the
placement raises and nothing runs on the CPU quietly. Code that wants the
CPU asks for it (``device="cpu"``, or a CPU tensor to follow). Callers reach
this function through the module attribute, ``device.default_device()``,
so that one patch of it covers every caller.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA card (the current CUDA device)."""
    return torch.device("cuda")
