"""``python -m coral_tpu_torch <command> [--device D] [overrides]``: see ``cli``."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
