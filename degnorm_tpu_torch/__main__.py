"""``python -m degnorm_tpu_torch`` — same entry as the ``degnorm-tpu-torch``
console script (reference degnorm/__main__.py:16)."""
import sys

from degnorm_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
