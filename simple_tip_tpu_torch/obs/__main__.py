"""``python -m simple_tip_tpu_torch.obs`` — the run-inspection CLI (see cli.py)."""

import sys

from simple_tip_tpu_torch.obs.cli import main

if __name__ == "__main__":
    sys.exit(main())
