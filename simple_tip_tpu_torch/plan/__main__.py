"""``python -m simple_tip_tpu_torch.plan`` entry point."""

import sys

from simple_tip_tpu_torch.plan.cli import main

if __name__ == "__main__":
    sys.exit(main())
