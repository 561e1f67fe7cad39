"""`python -m avenir_tpu_torch.analysis`: the auditors' command line
(`analysis/cli.py`)."""

import sys

from avenir_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
