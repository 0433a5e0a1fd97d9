"""Where the port runs: the CUDA card, unless the caller asks for the CPU.

There is no silent fallback. ``resolve_device()`` with no argument is the
first CUDA card and raises where there is none; the CPU is used only when
asked for by name (the tests do, to run the kernels' plain versions).
"""

from __future__ import annotations

import functools
import subprocess
from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]

#: SMs of an H100 SXM: what the kernels' launch plans assume where no
#: card is at hand (the wrappers plan with the card's own count)
H100_SMS = 132


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The current CUDA device by default (``cuda:0``, unless a process
    group's start-up gave this rank another card); raises when CUDA is
    absent and the CPU was not asked for."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                f"pass device='cpu' to run the plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index`` (what
    the kernels' launch plans fill)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def card_info(device: DeviceLike = None) -> dict:
    """Name and power limit of the card: ``torch.cuda.get_device_name``
    and ``nvidia-smi --query-gpu=name,power.limit`` (the limit a
    measurement has to be read beside). ``{"name": "cpu"}`` for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return {"name": "cpu", "power_limit": None, "nvidia_smi": None}
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    line = out.stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(dev),
            "power_limit": line.rsplit(",", 1)[-1].strip(),
            "nvidia_smi": line}
