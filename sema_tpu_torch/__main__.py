"""``python -m sema_tpu_torch index DIR`` / ``python -m sema_tpu_torch query TEXT``."""

import sys

from sema_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
