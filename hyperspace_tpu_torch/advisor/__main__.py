"""``python -m hyperspace_tpu_torch.advisor`` entry point."""

import sys

from hyperspace_tpu_torch.advisor.cli import main

if __name__ == "__main__":
    sys.exit(main())
