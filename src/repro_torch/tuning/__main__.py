"""``python -m repro_torch.tuning``: the autotuner CLI (``tuning/cli.py``)."""

import sys

from repro_torch.tuning.cli import main

sys.exit(main())
