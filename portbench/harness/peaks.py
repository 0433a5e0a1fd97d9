"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit), and the roofline
arithmetic every kernel's counts share."""

from __future__ import annotations

from typing import Tuple

#: operations per second by the precision they run in: f32 outside the
#: tensor cores, TF32, bf16 and fp16, fp8, int8 on the tensor cores
PEAK_OPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "fp16": 989e12,
            "fp8": 1979e12, "int8": 1979e12}
#: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
#: device memory of one card, bytes
HBM_BYTES = 80e9


def least_seconds(ops: float, nbytes: float, precision: str
                  ) -> Tuple[float, str]:
    """(least seconds, what bounds them): the larger of ``ops`` at the
    precision's peak and ``nbytes`` at the memory's rate."""
    t_ops = ops / PEAK_OPS[precision]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
