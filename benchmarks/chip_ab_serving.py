"""The serving phases of ``chip_smoke.py`` (``kernel`` once, ``slice``
twice) for one tree, so two commits can be compared on one card in one
call::

    python3 benchmarks/chip_ab_serving.py TREE LABEL

``TREE`` is a checkout of a commit (for the parent: ``git archive
<commit>`` unpacked into a git-ignored directory); the tree's own
``chip_smoke.py`` and package run, its kernels built into its own
``build/``. Run the trees in the order parent, change, change, parent,
one process each, and read the ``phase slice`` lines beside the
``AB <label>`` lines. Needs the CUDA card.
"""

import os
import sys
import time

tree, label = os.path.realpath(sys.argv[1]), sys.argv[2]
os.chdir(tree)
sys.path.insert(0, tree)
import chip_smoke as cs  # noqa: E402  (the tree's own script)
import torch  # noqa: E402

cs.phase_card()
cs.phase_build()
dev = torch.device("cuda", 0)
rng, U, V = cs.make_tables(0)
print(f"AB {label} tree={tree}", flush=True)
t = time.perf_counter()
row = cs.phase_kernel(rng, U, V, dev)
print(f"AB {label} kernel row {row} in {time.perf_counter() - t:.1f}s",
      flush=True)
for rep in range(2):
    n = cs.phase_slice(rng, U, V, dev)
    print(f"AB {label} slice rep {rep} launches={n}", flush=True)
