"""``python -m repro_torch.obs`` — CLI front of the flight recorder
(``report.py``)."""

import sys

from repro_torch.obs.report import main

sys.exit(main())
