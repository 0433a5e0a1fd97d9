"""``gram_table`` of this tree against an earlier tree's kernel, on one
card in one call::

    python3 benchmarks/chip_ab_gram_table.py PARENT_CSRC

``PARENT_CSRC`` holds the earlier tree's ``csrc/gram_table.cu`` and the
``gram_tile.cuh`` it includes (``git archive <commit>
predictionio_tpu_torch/csrc`` unpacked into a git-ignored directory). It
is built here with the tree's ``nvcc`` flags and bound through the C
entry it had before the redesign: ``(device, table, idx, wa, wb, B, L,
m, r, A, b, stream, *path)``, the path its own choice.

Cases: B = 8,192 rows of L = 512 uniform indices and weights in [0, 1)
from a seed; the 512-row table and the 26,744-row (ML-20M item) table at
r = 64, and 512 x 10 and 512 x 128, on both wires. Each case is held to
the plain version (``check_gram``), then timed in the order parent,
change (each path the table can take), change, parent: ``ms`` (one
event-timed call) and ``queued_ms`` (the launch queue kept full), beside
the bounds of ``chip_smoke.table_bounds``. Needs the CUDA card.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from predictionio_tpu_torch.ops import _build, gram  # noqa: E402

CASES = ((512, 64), (26744, 64), (512, 10), (512, 128))
B, L = 8192, 512


def parent_kernel(csrc: Path):
    """The earlier kernel, built from ``csrc`` and bound by its old ABI."""
    so = csrc / "libgram_table_parent.so"
    out = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
         str(csrc / "gram_table.cu")], capture_output=True, text=True)
    cs.check(out.returncode == 0, f"the parent's gram_table.cu did not "
             f"build: {out.stdout[-2000:]} {out.stderr[-2000:]}")
    lib = ctypes.CDLL(str(so))
    for name in ("gram_table_f32", "gram_table_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                       + [ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int

    def call(tab, idx, wa, wb):
        m, r = tab.shape
        A = torch.empty((B, r, r), device=tab.device)
        b = torch.empty((B, r), device=tab.device)
        path = ctypes.c_int(0)
        fn = (lib.gram_table_f32 if tab.dtype == torch.float32
              else lib.gram_table_bf16)
        err = fn(tab.device.index or 0, tab.data_ptr(), idx.data_ptr(),
                 wa.data_ptr(), wb.data_ptr(), B, L, m, r, A.data_ptr(),
                 b.data_ptr(), torch.cuda.current_stream().cuda_stream,
                 ctypes.byref(path))
        cs.check(err == 0, f"the parent's gram_table failed: {err}")
        return A, b

    return call


def main() -> int:
    card = cs.phase_card()
    parent = parent_kernel(Path(sys.argv[1]).resolve())
    dev = torch.device("cuda", 0)
    optin = cs.smem_optin(0)
    rng = np.random.default_rng(11)
    for wire in ("f32", "bf16"):
        for m, r in CASES:
            tab, idx, wa, wb = cs.table_inputs(rng, m, r, B, L, dev)
            if wire == "bf16":
                tab = tab.bfloat16()
            rows = int(torch.unique(idx).numel())
            b_ms, b_by, tc_ms, tc_by = cs.table_bounds(
                B, L, rows, r, tab.element_size(), 2 if wire == "bf16" else 3)
            paths = [p for p in (1, 2) if p == 2 or gram.gram_resident_bytes(
                m, r, tab.element_size()) <= optin]
            Ar, br = gram.gram_table_reference(tab, idx, wa, wb)
            for who in ["parent"] + paths:
                fn = parent if who == "parent" else (
                    lambda *a, p=who: gram.gram_table(*a, path=p))
                A, b = fn(tab, idx, wa, wb)
                torch.cuda.synchronize()
                cs.check_gram(f"{wire} {m}x{r} {who}", A, b, Ar, br, tab, wa,
                              wb)
            del A, b, Ar, br
            times = {}
            for who in ["parent"] + paths + paths[::-1] + ["parent"]:
                fn = parent if who == "parent" else (
                    lambda *a, p=who: gram.gram_table(*a, path=p))
                call = lambda: fn(tab, idx, wa, wb)  # noqa: E731
                times.setdefault(who, []).append(
                    (cs.median_ms(call, 10), cs.queued_ms(call, 10)))
            print(f"AB gram_table {wire} m={m} r={r} B={B} L={L} ms/queued_ms "
                  + " | ".join(
                      f"{'parent' if w == 'parent' else f'path {w}'} "
                      + " ".join(f"{a:.4f}/{q:.4f}" for a, q in v)
                      for w, v in times.items())
                  + f" | bound_ms={b_ms:.5f} ({b_by}) tc_bound_ms="
                  f"{tc_ms:.5f} ({tc_by}) | {cs.card_tag(card)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
