"""``degnorm-tpu-torch-test`` console entry: run this package's tests, the
``tests/test_torch_*.py`` files beside it (the counterpart of
``degnorm_tpu/testing.py``, itself the reference's ``degnorm_test``,
tests/__test__.py:23-35).  They hold the port against the JAX package, so
they need jax beside torch; extra arguments go to pytest."""
from __future__ import annotations

import glob
import os
import subprocess
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(repo_root, "tests",
                                          "test_torch_*.py")))
    if not files:
        print("tests/test_torch_*.py not found next to the package",
              file=sys.stderr)
        return 2
    args = sys.argv[1:] if argv is None else list(argv)
    return subprocess.call([sys.executable, "-m", "pytest", *files, "-q",
                            *args], cwd=repo_root)


if __name__ == "__main__":
    sys.exit(main())
