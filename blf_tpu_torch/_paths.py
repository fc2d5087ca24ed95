"""Where the package keeps what it builds at first use.

No counterpart in ``blf_tpu``. Both builders of the port, the CUDA one
(:mod:`blf_tpu_torch.ops.cuda._build`) and the host one
(:mod:`blf_tpu_torch.native`), put their libraries in :data:`BUILD_DIR`,
``blf_tpu_torch/_build/``, which git ignores.
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["PACKAGE_DIR", "BUILD_DIR"]

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "_build"
