"""Run one cell of the port's benchmark once; see ``portbench/harness.py``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Kernel and build caches stay inside it
(``blf_tpu_torch/_build/`` for the program's kernels; ``.portbench_cache/``
for PyTorch's extension and Triton caches, which these cells do not use).
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".portbench_cache" / sub)
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    import torch

    torch.set_num_threads(4)
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], STARTED))
